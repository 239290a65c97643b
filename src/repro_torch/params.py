"""Weights carried across from the JAX package.

Parameters live in a flat dict keyed by the paths that
``repro/training/checkpoint.py::_flatten`` writes (``embed``,
``final_norm/scale``, ``layers/attn/wq`` stacked as ``(L, ...)``, ...), in
JAX's orientation (``x @ W``), so a JAX param tree or checkpoint loads with
no conversion table.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> ``/``-joined flat keys (the checkpoint's layout)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``/``-joined flat keys -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ml_dtypes' numpy types (registered by name, never imported here) and the
# integer views that carry their bits
_BIT_VIEWS = {"bfloat16": (np.int16, torch.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn)}


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name in _BIT_VIEWS:
        np_int, _, dt = _BIT_VIEWS[arr.dtype.name]
        return torch.from_numpy(np.array(arr).view(np_int)).view(dt)
    return torch.from_numpy(np.array(arr))       # a writable copy


def from_jax(flat: Dict[str, np.ndarray], device,
             dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Flat JAX params (numpy leaves) -> tensors on ``device``.  ``dtype``
    casts every floating-point leaf."""
    out = {}
    for k, v in flat.items():
        t = _to_tensor(v)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def state_from_jax(state: Dict[str, Any], device) -> Dict[str, Any]:
    """A JAX decode state of any ported family, nested, with numpy or JAX
    leaves (bf16, float8_e4m3fn, float32 and int32 kept) -> the same
    nesting of tensors on ``device``, ready for the port's
    ``prefill``/``decode``: the dense
    KV cache (``{"cache": {"k", "v"}, "length"}``), rwkv6's recurrent state
    (``tm_shift``, ``cm_shift``, ``wkv``, ``length``), the hybrid's
    (``conv``, ``ssd``, ``shared_k``, ``shared_v``, ``length``), or the
    vlm's and encdec's self caches and fixed cross K/V (``k``, ``v``,
    ``xk``, ``xv``, ``length``)."""
    return unflatten(from_jax(flatten(state), device))


def to_flat(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors -> flat numpy leaves with the same keys, shapes and dtypes
    (bfloat16 and float8_e4m3fn as numpy's ``"bfloat16"`` and
    ``"float8_e4m3fn"`` dtypes, as the JAX package writes them: registered
    with numpy by ``ml_dtypes``, which JAX imports; the port itself never
    imports it)."""
    out = {}
    for k, t in params.items():
        t = t.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name in _BIT_VIEWS:
            _, int_dt, _ = _BIT_VIEWS[name]
            out[k] = t.view(int_dt).numpy().view(np.dtype(name))
        else:
            out[k] = t.numpy()
    return out
