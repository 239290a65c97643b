"""Logical-axis sharding rules: the port's copy of ``repro/sharding.py``.

Models name the logical axes of activations ("batch", "seq", "heads",
"ff", "embed", "vocab", "expert", "kv"); params get the logical axes of
their dims by leaf name.  The translation to mesh axes adapts to the mesh:

  single-pod mesh (data=16, model=16):   batch->data, heads/ff/vocab->model
  multi-pod mesh (pod=2, data=16, model=16): batch->(pod,data), rest as above

The 2D weight sharding (d_model dim -> data, ff/head dim -> model) is
HSDP-style, as in the JAX package.

The port runs on one card, so the rules are data: a spec is a tuple with
one entry per dim (a mesh axis name, a tuple of names, or None) where JAX
builds a ``PartitionSpec``, and a mesh is a ``launch.mesh.Mesh``
descriptor (any object with ``axis_names`` and a ``shape`` mapping),
always passed in.  JAX's active-mesh context (``use_mesh``/``get_mesh``)
and its activation constraint ``shard`` are not ported: one card has
nothing to constrain, as JAX's ``shard`` is a no-op without a mesh.  The
flags ``serve_tp`` and ``seq_parallel`` (``repro_torch.opt``) change the
translation as they change JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch import opt

Spec = Tuple  # one entry per dim: an axis name, a tuple of names, or None

# ---------------------------------------------------------------------------
# Logical -> physical translation
# ---------------------------------------------------------------------------

# logical axis -> preferred mesh axis (by name)
_LOGICAL = {
    "batch": ("data",),
    "expert": ("data",),       # expert parallelism rides the data axis
    "heads": ("model",),
    "kv": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "embed": ("data",),        # FSDP axis for the d_model dim of weights
    "seq": (),                 # unsharded by default (overridden for 500k KV)
    "seq_sp": (),              # residual-stream seq dim; ("model",) under
                               # the seq_parallel optimization (see below)
    "seq_shard": ("model",),   # KV seq sharded over model (decode, kv<16)
    "seq_full": ("data", "model"),  # KV seq sharded over ALL chips (batch=1)
    None: (),
}


def physical_axes(logical: Optional[str], mesh):
    """Mesh axes for one logical axis, given the mesh's axis names."""
    if logical is None:
        return None
    if logical == "seq_sp":
        return ("model" if (opt.enabled("seq_parallel")
                            and "model" in mesh.axis_names) else None)
    if logical == "embed" and opt.enabled("serve_tp"):
        # serving TP: the d_model dim of weights shards over `pod` (when
        # present) instead of `data`; batch stays on `data`.
        return "pod" if "pod" in mesh.axis_names else None
    want = _LOGICAL[logical]
    have = mesh.axis_names
    out = []
    for ax in want:
        if ax in have:
            out.append(ax)
        # pod extends the data axis (training batch / serving replicas)
        if ax == "data" and "pod" in have:
            out.insert(0, "pod")
    if not out:
        return None
    return tuple(out) if len(out) > 1 else out[0]


def logical_to_spec(*logical_axes, mesh=None) -> Spec:
    """The mesh axes of each logical axis; () without a mesh (JAX's
    ``P()``)."""
    if mesh is None:
        return ()
    return tuple(physical_axes(a, mesh) for a in logical_axes)


# ---------------------------------------------------------------------------
# Parameter specs by leaf name
# ---------------------------------------------------------------------------

# Leaf-name -> logical axes of the *trailing* dims (layer-stack dims handled
# by rank padding below).  Names match the init functions in
# repro_torch.models (the JAX package's names).
_PARAM_RULES = {
    # embeddings / head
    "embed": ("vocab", "embed"),
    "head": ("embed", "vocab"),
    "pos_embed": (None, None),
    # attention
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv"),
    "wv": ("embed", "kv"),
    "wo": ("heads", "embed"),
    "bq": ("heads",), "bk": ("kv",), "bv": ("kv",), "bo": (None,),
    # MLA
    "q_a": ("embed", None),
    "q_b": (None, "heads"),
    "kv_a": ("embed", None),
    "kv_b": (None, "heads"),
    # mlp
    "w_gate": ("embed", "ff"),
    "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
    "b_gate": ("ff",), "b_up": ("ff",), "b_down": (None,),
    # MoE (leading expert dim)
    "we_gate": ("expert", None, "ff"),
    "we_up": ("expert", None, "ff"),
    "we_down": ("expert", "ff", None),
    "router": ("embed", None),
    # shared expert uses plain mlp names via ws_* aliases
    "ws_gate": ("embed", "ff"),
    "ws_up": ("embed", "ff"),
    "ws_down": ("ff", "embed"),
    # rwkv6 square mixes
    "w_r": ("embed", "heads"), "w_k": ("embed", "heads"),
    "w_v": ("embed", "heads"), "w_g": ("embed", "heads"),
    "w_o": ("heads", "embed"),
    # mamba2
    "in_proj": ("embed", "ff"),
    "out_proj": ("ff", "embed"),
    "conv_w": (None, "ff"),
    "conv_b": ("ff",),
    # vlm / zamba2 adapters
    "img_k": ("embed", "kv"), "img_v": ("embed", "kv"),
    "concat_proj": (None, "embed"),
    "lora_a": ("embed", None), "lora_b": (None, "heads"),
}

_REPLICATED_SUFFIXES = (
    "scale", "bias", "mu", "decay", "first", "gate_scalar", "dt_bias",
    "a_log", "d_skip", "norm", "qnorm", "knorm",
)


def spec_for_leaf(key: str, leaf) -> Spec:
    """The logical axes of one param leaf, from its name (the last
    component of its ``/``-joined key, as ``repro_torch.params`` keys the
    flat params) and its rank."""
    name = key.rsplit("/", 1)[-1] if key else None
    rank = len(leaf.shape)
    if not name:
        return ()
    base = _PARAM_RULES.get(name)
    if base is None:
        # the replicated suffixes, and unknown leaves: replicate
        return (None,) * rank
    # pad leading layer-stack dims with None
    pad = rank - len(base)
    if pad < 0:  # leaf smaller than rule (e.g. smoke config folded dims)
        base = base[-rank:]
        pad = 0
    return (None,) * pad + tuple(base)


def param_specs(params: Dict[str, object], mesh=None) -> Dict[str, Spec]:
    """Each flat param's spec translated for ``mesh``; () for every leaf
    without one."""

    def one(key, leaf):
        if mesh is None:
            return ()
        return tuple(physical_axes(a, mesh) if isinstance(a, str) else None
                     for a in spec_for_leaf(key, leaf))

    return {k: one(k, v) for k, v in params.items()}
