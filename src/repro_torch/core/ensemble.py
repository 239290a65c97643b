"""Multi-model ensembles behind a single endpoint (paper §2.1, §2.2).

The paper's ``fmodels`` module loads N models into one shared memory space
and runs them in a SINGLE forward call.  Here:

  * every member's params live on the same CUDA device (one memory pool),
    accounted by a MemoryLedger;
  * ``forward`` is ONE call evaluating every member on the SAME input
    batch, moved to the device once — the paper's "removes the additional
    data transformation calls" claim;
  * outputs are combined under a client-chosen sensitivity policy and
    formatted as the paper's `{'model_i': [class, ...]}` JSON schema.

Membership is SWAPPABLE under live traffic: the forward, its param list,
and the bucketed batcher live in an immutable ``_EnsembleState``;
``set_members`` builds (and optionally pre-warms) a new state off the hot
path, publishes it with one atomic reference assignment, then drains
in-flight forwards on the old state before the caller retires the old
params.  Post-processing reads member names from the logits dict itself,
so a request whose forward ran on the old state formats correctly even
after the swap.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import policies as pol
from repro_torch.core.batching import BucketSpec, FlexibleBatcher, to_numpy
from repro_torch.core.memory import MemoryLedger


# the batcher's counters, as ``/metrics`` ``ensemble_batches`` reports them
BATCH_COUNTS = ("forwards", "rows_total", "padded_rows_total")


def _np_softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _device_of(params) -> torch.device:
    if isinstance(params, torch.Tensor):
        return params.device
    for v in (params.values() if isinstance(params, dict) else params):
        return _device_of(v)
    raise ValueError("member params hold no tensor")


@dataclass
class EnsembleMember:
    """name + pure apply: (params, batch of device tensors) -> class logits
    (B, C) on the params' device."""

    name: str
    apply: Callable[[Any, Dict[str, Any]], torch.Tensor]
    params: Any
    num_classes: int


class _EnsembleState:
    """One immutable membership snapshot: members, forward, batcher.

    In-flight forwards are counted so a hot swap can drain the state
    before the old params are released.
    """

    def __init__(self, members: Sequence[EnsembleMember], max_batch: int):
        if not members:
            raise ValueError("ensemble needs at least one member")
        self.members = list(members)
        names = [m.name for m in self.members]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate member names: {names}")
        devices = {_device_of(m.params) for m in self.members}
        if len(devices) != 1:
            raise ValueError(f"members on several devices: {devices}")
        self.device = devices.pop()

        members = self.members

        def _forward_all(batch):
            # ONE call spanning every member; inference_mode is
            # thread-local, so it is entered here, on the calling
            # (coalescer dispatch) thread.  It closes over the member
            # list, not over ``self``: no reference cycle, so a retired
            # state's params are freed as soon as it is dropped (an
            # unloaded version's device memory comes back at once)
            with torch.inference_mode():
                return {m.name: m.apply(m.params, batch) for m in members}

        self.batcher = FlexibleBatcher(_forward_all,
                                       BucketSpec.pow2(max_batch),
                                       self.device)
        self._inflight = 0
        self._cv = threading.Condition()

    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with self._cv:
            self._inflight += 1
        try:
            return self.batcher(batch)
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def warm(self, example_batch: Dict[str, Any]) -> float:
        return self.batcher.warm(example_batch)

    def drain(self, timeout: float) -> bool:
        """Block until no forward is executing on this state (or timeout)."""
        deadline = time.perf_counter() + timeout
        with self._cv:
            while self._inflight:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True


class Ensemble:
    """N models, one endpoint, one forward call, one memory space."""

    def __init__(self, members: Sequence[EnsembleMember],
                 max_batch: int = 64,
                 class_names: Optional[List[str]] = None):
        self.class_names = class_names
        self.max_batch = max_batch
        self._state = _EnsembleState(members, max_batch)
        self._swap_lock = threading.Lock()
        self._retired_compiles: Dict[int, int] = {}
        self._retired_batches: Dict[str, int] = dict.fromkeys(
            BATCH_COUNTS, 0)

    @property
    def members(self) -> List[EnsembleMember]:
        return self._state.members

    # --- lifecycle ----------------------------------------------------------

    def set_members(self, members: Sequence[EnsembleMember], *,
                    warm_batch: Optional[Dict[str, Any]] = None,
                    drain_timeout: float = 30.0) -> Dict[str, Any]:
        """Hot-swap membership under live traffic.

        Builds the new forward + batcher OFF the hot path, runs each of
        its buckets once against ``warm_batch`` when given, atomically publishes
        the new state, then drains in-flight forwards on the old state so the
        caller may safely retire the old params.  Requests that began on the
        old state finish on it; requests that arrive after the publish see
        only the new membership.
        """
        new = _EnsembleState(members, self.max_batch)
        warm_s = new.warm(warm_batch) if warm_batch is not None else 0.0
        with self._swap_lock:
            old, self._state = self._state, new
        drained = old.drain(drain_timeout)
        with self._swap_lock:
            # fold the retired state's compile counts so /metrics totals
            # stay cumulative across swaps
            for b, c in old.batcher.compiles.items():
                self._retired_compiles[b] = \
                    self._retired_compiles.get(b, 0) + c
            for k, c in old.batcher.counts().items():
                self._retired_batches[k] += c
        return {"warm_s": warm_s, "drained": drained,
                "members": [m.name for m in new.members]}

    def warm(self, example_batch: Dict[str, Any]) -> float:
        """Run the CURRENT state's buckets once (startup warm-up)."""
        return self._state.warm(example_batch)

    # --- inference ----------------------------------------------------------

    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Per-member logits (tensors on the ensemble's device) for a
        variable-size batch of host arrays (bucketed)."""
        return self._state.forward(batch)

    def probs_from_logits(self, logits: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Per-member class probabilities, computed on the HOST in numpy.

        Post-processing runs once per request (not per batch) on tiny
        (B, C) arrays; numpy avoids device dispatch from many handler
        threads.  Device or bfloat16 logits cross to the host through
        ``to_numpy`` (``.float().cpu().numpy()``)."""
        return {k: _np_softmax(to_numpy(v)) for k, v in logits.items()}

    def probs(self, batch) -> Dict[str, np.ndarray]:
        return self.probs_from_logits(self.forward(batch))

    def classify_from_logits(self, logits: Dict[str, Any],
                             policy: str = "soft_vote",
                             weights: Optional[np.ndarray] = None
                             ) -> Dict[str, Any]:
        """Policy combination on precomputed per-member logits — the
        post-processing half of a coalesced forward (per-request, cheap).

        Member identity comes from the logits dict (insertion-ordered by
        the forward that produced it), NOT from current membership: the
        membership may have been swapped while this request's rows were in
        flight."""
        probs = self.probs_from_logits(logits)
        names = list(probs)
        stacked = np.stack([probs[n] for n in names])            # (M,B,C)
        per_member = {n: np.argmax(probs[n], -1) for n in names}
        fn = pol.get_policy(policy)
        if policy in pol.PROB_POLICIES:
            combined = fn(stacked, weights if weights is None
                          else np.asarray(weights))
        else:
            raise ValueError(f"{policy!r} is a binary policy; use detect()")
        return {"members": per_member, "ensemble": combined}

    def classify(self, batch, policy: str = "soft_vote",
                 weights: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Per-member argmax classes + policy-combined ensemble output."""
        return self.classify_from_logits(self.forward(batch), policy=policy,
                                         weights=weights)

    def detect_from_logits(self, logits: Dict[str, Any], positive_class: int,
                           threshold: float = 0.5, policy: str = "or",
                           weights: Optional[np.ndarray] = None
                           ) -> Dict[str, Any]:
        probs = self.probs_from_logits(logits)
        names = list(probs)
        binary = np.stack([probs[n][:, positive_class] > threshold
                           for n in names])                      # (M, B)
        fn = pol.BINARY_POLICIES[policy]
        combined = (fn(binary, np.asarray(weights))
                    if policy == "weighted" else fn(binary))
        return {"members": {n: binary[i] for i, n in enumerate(names)},
                "ensemble": combined}

    def detect(self, batch, positive_class: int, threshold: float = 0.5,
               policy: str = "or",
               weights: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Binary target detection with a sensitivity policy (paper's use
        case: y' = y_1 | ... | y_n for maximum sensitivity)."""
        return self.detect_from_logits(self.forward(batch), positive_class,
                                       threshold=threshold, policy=policy,
                                       weights=weights)

    # --- paper-schema response ------------------------------------------------

    def respond_from_logits(self, logits: Dict[str, Any],
                            policy: str = "soft_vote") -> Dict[str, Any]:
        """FlexServe JSON schema from precomputed logits (coalesced path)."""
        out = self.classify_from_logits(logits, policy=policy)
        return self._format_response(out, policy)

    def respond(self, batch, policy: str = "soft_vote") -> Dict[str, Any]:
        """FlexServe JSON schema: {'model_i': ['class', ...], ...}."""
        return self._format_response(self.classify(batch, policy=policy),
                                     policy)

    def _format_response(self, out: Dict[str, Any],
                         policy: str) -> Dict[str, Any]:
        def names(ids):
            ids = np.asarray(ids)
            if self.class_names:
                return [self.class_names[int(i)] for i in ids]
            return [f"class_{int(i)}" for i in ids]

        resp = {f"model_{i}": names(v)
                for i, v in enumerate(out["members"].values())}
        resp["ensemble"] = names(out["ensemble"])
        resp["policy"] = policy
        return resp

    @property
    def batch_buckets(self) -> BucketSpec:
        return self._state.batcher.buckets

    @property
    def compile_counts(self) -> Dict[int, int]:
        """Per-bucket first-use counts, cumulative across swaps (the
        bounded set of shapes served)."""
        with self._swap_lock:
            out = dict(self._retired_compiles)
            for b, c in self._state.batcher.compiles.items():
                out[b] = out.get(b, 0) + c
        return out

    @property
    def batch_counts(self) -> Dict[str, int]:
        """The batcher's ``forwards``, ``rows_total`` and
        ``padded_rows_total``, cumulative across swaps."""
        with self._swap_lock:
            now = self._state.batcher.counts()
            return {k: self._retired_batches[k] + now[k]
                    for k in BATCH_COUNTS}

    @property
    def device(self) -> torch.device:
        """The device the members' params (and their forwards) are on."""
        return self._state.device

    # --- shared-memory accounting ----------------------------------------------

    def memory_ledger(self, n_chips: int = 1, **kw) -> MemoryLedger:
        """Params of every member against the card's memory (pass
        ``hbm_per_chip`` on a host without a CUDA device)."""
        ledger = MemoryLedger(n_chips=n_chips, **kw)
        for m in self.members:
            ledger.add_params(m.name, m.params)
        return ledger

    @property
    def num_compilations(self) -> int:
        return sum(self.compile_counts.values())
