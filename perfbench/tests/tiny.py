"""A cell the CPU tests can hold: the port's smoke-size yi-9b (2 layers,
d_model 256, 4/1 heads of 64, float32) in pairs, at a few rows of 16
tokens, driven through the same harness as the card's cells."""

from __future__ import annotations

import copy
from typing import Any, Dict

from perfbench.harness import spec

TINY_ARCH = {"num_layers": 2, "d_model": 256, "num_heads": 4,
             "num_kv_heads": 1, "head_dim": 64, "d_ff": 512,
             "vocab_size": 512, "sliding_window": None,
             "rope_theta": 10000.0, "norm_eps": 1e-05, "dtype": "float32"}

TINY_CONFIG: Dict[str, Any] = {
    "name": "tiny-pair", "source": "the port's reduce_for_smoke(yi-9b)",
    "reduced": [], "members": ["yi-9b", "yi-9b"], "port_reduced": True,
    "app": "ensemble", "reference": "dense_gqa", "arch": TINY_ARCH,
    "num_classes": 16, "max_batch": 4, "max_queue": 64,
    # as many rows checked as a closed-loop request holds, as in the cells
    "check": {"ref_rows": 4, "limits": {"logit_err": 1e-4}}}

CLOSED = {"request": "infer", "loop": "closed", "clients": 2,
          "rows": [[4, 1]], "seq_len": 16, "policy": "soft_vote"}
OPEN = {"request": "infer", "loop": "open", "rate_per_s": 40.0,
        "max_in_flight": 8, "rows": [[1, 2], [2, 1], [3, 1]],
        "seq_len": 16, "policy": "soft_vote"}


def cell(traffic=CLOSED, trace: bool = False, **config) -> spec.Cell:
    """The tiny cell with the metrics it reports (every end-to-end one,
    and the per-layer ones that read no device trace)."""
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg.update(config)
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    per_layer = [m for m in bench["per_layer"]
                 if m["source"] != "device_trace"]
    return spec.Cell("tiny-pair.test", 1, cfg, copy.deepcopy(traffic),
                     end_to_end=list(bench["end_to_end"]),
                     per_layer=per_layer)
