"""``POST /v1/infer``: rows of token ids in, each member's class and the
policy's ensemble class out (``{"model_0": ["class_3", ...], ...,
"ensemble": [...], "policy": ...}``)."""

from __future__ import annotations

import json
from typing import List, Mapping, Optional, Sequence

import numpy as np

PATH = "/v1/infer"
# an answered class counts as the best one where its margin below the
# best lies within this (float32 rounding of equal or tied scores)
TIE = 1e-6


def encoder(policy: str):
    def encode(tokens: np.ndarray) -> bytes:
        return json.dumps({"inputs": {"tokens": tokens.tolist()},
                           "policy": policy}).encode()
    return encode


def classes(answer: Mapping, key: str) -> List[int]:
    return [int(str(c).rsplit("_", 1)[1]) for c in answer[key]]


def softmax64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def soft_vote_gap(member_logits: Sequence[np.ndarray], cls: int) -> float:
    """How far the mean of the members' class probabilities for ``cls``
    lies below the best class's."""
    p = np.mean([softmax64(lg) for lg in member_logits], axis=0)
    return float(p.max() - p[cls])


def wrong_answers(body: bytes, tokens: np.ndarray, members: Sequence[str],
                  program: Mapping[bytes, Mapping[str, np.ndarray]],
                  policy: str) -> Optional[int]:
    """How many of a response's answers do not follow from the logits the
    members' readouts produced for its rows (each member's class against
    its argmax, the ensemble's against the soft vote), counting a row that
    no forward produced as wrong in every answer; None for a body that is
    not the route's answer at all."""
    try:
        answer = json.loads(body)
        member_classes = [classes(answer, f"model_{i}")
                          for i in range(len(members))]
        ensemble = classes(answer, "ensemble")
    except (ValueError, KeyError, IndexError, TypeError):
        return None
    if policy != "soft_vote":
        raise ValueError(f"the check knows the soft_vote policy, "
                         f"not {policy!r}")
    rows = tokens.shape[0]
    if len(ensemble) != rows or any(len(c) != rows for c in member_classes):
        return (len(members) + 1) * rows
    wrong = 0
    for r in range(rows):
        got = program.get(tokens[r].tobytes())
        if got is None or any(m not in got for m in members):
            wrong += len(members) + 1
            continue
        lgs = [got[m] for m in members]
        for lg, cl in zip(lgs, member_classes):
            wrong += int(not (0 <= cl[r] < lg.shape[0])
                         or lg.max() - lg[cl[r]] > TIE)
        wrong += int(not (0 <= ensemble[r] < lgs[0].shape[0])
                     or soft_vote_gap(lgs, ensemble[r]) > TIE)
    return wrong
