"""Sharding assignment for the dry-run's inputs -- params, optimizer
state, decode caches and data batches -- as data: the port of
``repro/launch/shardings.py``.

Specs are tuples (``repro_torch.sharding``), one entry per dim, over a
``launch.mesh.Mesh`` descriptor; there is no ``NamedSharding``, since one
card places every tensor whole.  Trees are the port's: the flat param
dict, ``OptState`` and the nested dict of a decode state, whose leaf name
is its last key.

Parameter specs come from ``repro_torch.sharding``'s leaf-name rules
(HSDP: d_model dim -> data axis, head/ff/vocab dim -> model axis, expert
dim -> data).  Decode-state specs are chosen per shape:
  * batch dim -> ("pod","data") when divisible (decode_32k, prefill_32k);
  * kv-head dim -> "model" when there are >= model_size kv heads;
  * otherwise the KV *sequence* dim -> "model";
  * long-context batch=1 -> sequence over ALL chips ("data","model").
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import data_axis_size, model_axis_size
from repro_torch.sharding import Spec, param_specs
from repro_torch.training.optimizer import OptState


def _batch_axes(mesh):
    return (("pod", "data") if "pod" in mesh.axis_names else ("data",))


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    n = 1
    for a in entry:
        n *= mesh.shape[a]
    return n


def map_tree(fn: Callable[[tuple, Any], Any], tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict (or ``OptState``) of leaves,
    keeping its structure; ``path`` is the tuple of keys down to the
    leaf."""
    if isinstance(tree, OptState):
        return OptState(*(map_tree(fn, t, path + (name,))
                          for name, t in zip(OptState._fields, tree)))
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop sharding on any dim whose size isn't divisible by its mesh
    axes (e.g. whisper's vocab 51865 can't split 16 ways)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n = _axis_size(mesh, entry)
        out.append(entry if (n > 1 and dim % n == 0) or n == 1 else None)
    return tuple(out)


def sanitize_tree(tree, spec_tree, mesh):
    """``sanitize_spec`` leaf by leaf over two trees of one structure."""
    specs = {}

    def collect(path, spec):
        specs[path] = spec
    map_tree(collect, spec_tree)
    return map_tree(lambda path, leaf: sanitize_spec(specs[path],
                                                     leaf.shape, mesh), tree)


def batch_spec(mesh, batch: int, rank: int) -> Spec:
    axes = _batch_axes(mesh)
    n = data_axis_size(mesh)
    if batch % n == 0 and batch >= n:
        lead = axes if len(axes) > 1 else axes[0]
        return (lead,) + (None,) * (rank - 1)
    return (None,) * rank


# --- decode / prefill state ---------------------------------------------------

_SEQ_CACHE_NAMES = {"k", "v", "xk", "xv", "shared_k", "shared_v"}
_LATENT_CACHE_NAMES = {"ckv", "krope"}


def state_specs(state, cfg: ModelConfig, mesh):
    """Each decode-state leaf's spec, by leaf name and rank."""
    del cfg
    dsize = data_axis_size(mesh)
    msize = model_axis_size(mesh)
    batch_lead = (("pod", "data") if "pod" in mesh.axis_names else "data")
    all_chips = (("pod", "data", "model") if "pod" in mesh.axis_names
                 else ("data", "model"))

    def one(path, leaf):
        name = path[-1] if path else ""
        rank = len(leaf.shape)
        spec = [None] * rank
        if name == "length":
            return tuple(spec)
        if name in _SEQ_CACHE_NAMES and rank >= 4:
            # (..., B, S, K, hd)
            b_ax, s_ax, k_ax = rank - 4, rank - 3, rank - 2
            B, K = leaf.shape[b_ax], leaf.shape[k_ax]
            if B % dsize == 0 and B >= dsize:
                spec[b_ax] = batch_lead
                if K % msize == 0 and K >= msize:
                    spec[k_ax] = "model"
                elif leaf.shape[s_ax] % msize == 0:
                    spec[s_ax] = "model"
            else:  # batch=1 long-context: shard seq over ALL chips
                if leaf.shape[s_ax] % (dsize * msize) == 0:
                    spec[s_ax] = all_chips
            return tuple(spec)
        if name in _LATENT_CACHE_NAMES and rank >= 3:
            # (L, B, S, C)
            b_ax, s_ax = rank - 3, rank - 2
            B = leaf.shape[b_ax]
            if B % dsize == 0 and B >= dsize:
                spec[b_ax] = batch_lead
                if leaf.shape[s_ax] % msize == 0:
                    spec[s_ax] = "model"
            elif leaf.shape[s_ax] % (dsize * msize) == 0:
                spec[s_ax] = all_chips
            return tuple(spec)
        # the recurrent states: (L, B, H or D or C, ...), batch on dim 1
        # and the head, width or channel dim on dim 2 (conv: dim 3)
        head_dim = {("wkv", 5): 2, ("tm_shift", 3): 2, ("cm_shift", 3): 2,
                    ("conv", 4): 3, ("ssd", 5): 2}.get((name, rank))
        if head_dim is not None:
            if leaf.shape[1] % dsize == 0:
                spec[1] = batch_lead
            if leaf.shape[head_dim] % msize == 0:
                spec[head_dim] = "model"
        return tuple(spec)

    return map_tree(one, state)


def state_specs_sanitized(state, cfg: ModelConfig, mesh):
    """``state_specs`` with the undivisible dims dropped: what the JAX
    package's ``state_shardings`` places."""
    return sanitize_tree(state, state_specs(state, cfg, mesh), mesh)


def param_specs_for(params: Dict[str, Any], mesh) -> Dict[str, Spec]:
    """The flat params' specs, sanitized (JAX's
    ``param_shardings_for``)."""
    return sanitize_tree(params, param_specs(params, mesh), mesh)


def opt_state_specs(params: Dict[str, Any], mesh) -> OptState:
    """The optimizer state's specs: the step replicated, both moments as
    their params."""
    pspec = param_specs_for(params, mesh)
    return OptState(step=(), mu=pspec, nu=dict(pspec))
