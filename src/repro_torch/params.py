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


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes' numpy bfloat16
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
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
    leaves (bf16, float32 and int32 kept) -> the same nesting of tensors
    on ``device``, ready for the port's ``prefill``/``decode``: the dense
    KV cache (``{"cache": {"k", "v"}, "length"}``), rwkv6's recurrent state
    (``tm_shift``, ``cm_shift``, ``wkv``, ``length``), the hybrid's
    (``conv``, ``ssd``, ``shared_k``, ``shared_v``, ``length``), or the
    vlm's and encdec's self caches and fixed cross K/V (``k``, ``v``,
    ``xk``, ``xv``, ``length``)."""
    return unflatten(from_jax(flatten(state), device))


def to_flat(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors -> flat numpy leaves with the same keys, shapes and dtypes
    (bfloat16 as numpy's ``"bfloat16"`` dtype, as the JAX package writes
    it: registered with numpy by ``ml_dtypes``, which JAX imports; the
    port itself never imports it)."""
    out = {}
    for k, t in params.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[k] = t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
        else:
            out[k] = t.numpy()
    return out
