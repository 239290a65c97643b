"""Optimization flags: the port's copy of ``repro/opt.py``'s table.

The same ten names and defaults, the same ``enabled``, ``set_flags``,
``parse`` ('none' | 'all' | a comma list, 'all,x' too), ``flags()`` and
``all_flags``, with the same errors, and the same thread-local state: a
flag set in one thread is not seen by another.

What reads each flag in the port:
  kv_cache_f8   — ``models/attention.py::cache_dtype``: a bfloat16 config's
                  GQA KV caches and page pools are float8_e4m3fn.  Read
                  where a state is allocated, never by a tick: everything
                  downstream keys on the cache tensor's dtype.  An engine
                  records this flag and ``ring_cache`` when it is built and
                  allocates every later state under them, so a scheduler's
                  service thread makes the states its builder asked for.
  ring_cache    — the ``init_state`` of ``models/transformer.py``,
                  ``hybrid.py`` and ``vlm.py``: a sliding-window cache is a
                  ring of ``min(max_len, window)`` slots; off, a full
                  ``max_len`` cache with the window as a mask.
  attn_dtype    — the plain attention paths (``gqa_attention``, MLA's
                  decode, the plain one-token attention): on, P is cast to
                  the value dtype before P.V; off, P and V stay float32.
                  The Hopper kernels keep their own precision either way.
  chunked_ce    — ``models/transformer.py::train_loss``: with a vocab of
                  at least 32768 the loss streams the head by vocab chunk
                  (``layers.chunked_cross_entropy``) and never makes the
                  (B, S, V) logits.
  opt_bf16_moments — ``launch/dryrun.py``: a training step's moments
                  are bfloat16 under it, float32 without, as in the JAX
                  package, whose ``Trainer`` takes
                  ``OptimizerConfig.moment_dtype`` (only its dry-run reads
                  the flag).
  serve_tp, seq_parallel — ``sharding.py::physical_axes``: the d_model
                  dim of weights on ``pod`` (or unsharded) in place of
                  ``data``, and the residual stream's sequence dim on
                  ``model``, in the specs the port keeps as data (one card
                  places every tensor whole).
  pallas_attn, pallas_paged_decode — read by nothing: in the port the
                  tensor's device chooses the kernel (CUDA) or its plain
                  version (CPU), and no flag forces either.
  moe_ep — read by nothing: the JAX package's expert-parallel all-to-all
                  (``moe_block_ep``) needs a mesh's data axis, which one
                  card lacks; ``moe_block`` is the whole dispatch.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

_DEFAULTS: Dict[str, bool] = {
    "attn_dtype": True,
    "ring_cache": True,
    "opt_bf16_moments": True,
    "moe_ep": True,
    "kv_cache_f8": False,
    "pallas_attn": False,
    "seq_parallel": False,
    "chunked_ce": False,
    "serve_tp": False,
    "pallas_paged_decode": False,
}

_state = threading.local()


def _flags() -> Dict[str, bool]:
    if not hasattr(_state, "flags"):
        _state.flags = dict(_DEFAULTS)
    return _state.flags


def enabled(name: str) -> bool:
    return _flags().get(name, False)


def set_flags(**kw: bool) -> None:
    for k, v in kw.items():
        if k not in _DEFAULTS:
            raise KeyError(f"unknown optimization flag {k!r}; "
                           f"available: {sorted(_DEFAULTS)}")
        _flags()[k] = bool(v)


def parse(spec: str) -> Dict[str, bool]:
    """'none' | 'all' | comma-list of flags ('all,extra_flag' works too)."""
    if spec == "all":
        return {k: True for k in _DEFAULTS}
    if spec == "none":
        return {k: False for k in _DEFAULTS}
    chosen = {s.strip() for s in spec.split(",") if s.strip()}
    base_all = "all" in chosen
    chosen.discard("all")
    unknown = chosen - set(_DEFAULTS)
    if unknown:
        raise KeyError(f"unknown optimization flags {sorted(unknown)}")
    return {k: (base_all or k in chosen) for k in _DEFAULTS}


@contextlib.contextmanager
def flags(**kw: bool):
    old = dict(_flags())
    try:
        set_flags(**kw)
        yield
    finally:
        _state.flags = old


def all_flags() -> Dict[str, bool]:
    return dict(_flags())
