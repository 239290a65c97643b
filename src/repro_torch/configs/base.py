"""Model configuration system.

Every assigned architecture is expressed as a single frozen ``ModelConfig``
instance; family-specific blocks (MoE, MLA, SSM, hybrid, enc-dec, VLM) are
optional sub-configs so one model builder can dispatch on them.

Configs are *data*: importing this module never touches jax device state.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs (family-specific blocks)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block (qwen3-moe, deepseek-v3)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    first_k_dense: int = 0          # leading dense layers (deepseek-v3: 3)
    d_ff_dense: int = 0             # d_ff of those dense layers
    router_aux_weight: float = 1e-3
    norm_topk_prob: bool = True


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (deepseek-v3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Attention-free recurrent family (rwkv6) / Mamba2 (zamba2 backbone)."""

    kind: str = "rwkv6"             # "rwkv6" | "mamba2"
    state_size: int = 64            # per-head recurrent state dim
    head_dim: int = 64
    expand: int = 2                 # mamba2 inner expansion
    conv_kernel: int = 4            # mamba2 depthwise conv width
    chunk_size: int = 128           # SSD / WKV chunk length


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + shared attention block."""

    shared_block_period: int = 6    # apply the shared attn block every N layers
    shared_window: int = 4096       # KV window used by the shared block in decode


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder. The conv/mel frontend is a stub:
    input_specs() hands the encoder precomputed frame embeddings."""

    encoder_layers: int = 6
    encoder_frames: int = 1500      # whisper 30s @ 50Hz after conv stride 2
    max_target_positions: int = 448


@dataclass(frozen=True)
class VLMConfig:
    """Llama-3.2-Vision style: interleaved cross-attention image layers.
    The ViT + projector frontend is a stub: input_specs() hands the decoder
    precomputed patch embeddings."""

    cross_attn_layers: Tuple[int, ...] = ()
    image_tokens: int = 1601        # (560/14)^2 + 1 CLS
    vision_dim: int = 4096          # post-projector width


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    source: str                     # citation from the assignment table
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0               # 0 -> d_model // num_heads
    attn_kind: str = "gqa"          # gqa | mla | none
    sliding_window: Optional[int] = None   # native SWA (h2o-danube)
    rope_theta: float = 10000.0
    use_bias: bool = False
    use_qk_norm: bool = False       # qwen3
    norm_kind: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    parallel_block: bool = False    # cohere/command-r parallel attn+mlp
    logit_softcap: Optional[float] = None
    norm_eps: float = 1e-5
    max_position: int = 131072
    dtype: str = "bfloat16"

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None

    mtp: bool = False               # deepseek-v3 multi-token prediction head

    # ---- derived -----------------------------------------------------------

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: num_heads={self.num_heads} not divisible by "
                f"num_kv_heads={self.num_kv_heads}"
            )

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == "none"

    # Parameter count (embedding + blocks), used by MemoryLedger and the
    # roofline MODEL_FLOPS term.  Counts follow each family's actual
    # parameterization in models/.
    def param_count(self, active_only: bool = False) -> int:
        d, ff, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        emb = v * d
        head = 0 if self.tie_embeddings else v * d

        def attn_params() -> int:
            if self.attn_kind == "mla":
                m = self.mla
                qh = self.num_heads * (m.rope_head_dim + m.nope_head_dim)
                return (
                    d * m.q_lora_rank + m.q_lora_rank * qh            # q down/up
                    + d * (m.kv_lora_rank + m.rope_head_dim)          # kv down
                    + m.kv_lora_rank
                    * self.num_heads * (m.nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d               # o proj
                )
            if self.attn_kind == "none":
                return 0
            hd = self.head_dim
            return (
                d * self.num_heads * hd
                + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d
            )

        def mlp_params(dff: int) -> int:
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * dff

        per_layer = 0
        if self.family in ("dense", "vlm", "encdec"):
            per_layer = attn_params() + mlp_params(ff)
        elif self.family == "moe":
            m = self.moe
            n_routed = m.top_k if active_only else m.num_experts
            moe_mlp = (n_routed + m.num_shared_experts) * mlp_params(m.d_ff_expert)
            router = d * m.num_experts
            dense_layers = m.first_k_dense
            moe_layers = L - dense_layers
            dense_part = dense_layers * (attn_params() + mlp_params(m.d_ff_dense or ff))
            return emb + head + dense_part + moe_layers * (attn_params() + moe_mlp + router)
        elif self.family == "ssm":
            s = self.ssm
            if s.kind == "rwkv6":
                # time-mix (r,k,v,g,o + decay/first) + channel-mix
                per_layer = 5 * d * d + 2 * d + mlp_params(ff)
            else:
                inner = s.expand * d
                per_layer = d * 2 * inner + inner * d + mlp_params(ff)
        elif self.family == "hybrid":
            s = self.ssm
            inner = s.expand * d
            mamba = d * 2 * inner + inner * d
            n_shared_applications = L // (self.hybrid.shared_block_period or L)
            shared_block = attn_params() + mlp_params(ff)   # weights shared once
            return emb + head + L * mamba + shared_block
        total = emb + head + L * per_layer
        if self.family == "vlm" and self.vlm:
            # cross-attn layers add their own attn params
            total += len(self.vlm.cross_attn_layers) * attn_params()
        if self.family == "encdec" and self.encdec:
            total += self.encdec.encoder_layers * (attn_params() + mlp_params(ff))
            total += L * attn_params()   # decoder cross-attention
        return total

    def param_bytes(self, bytes_per_param: int = 2) -> int:
        return self.param_count() * bytes_per_param


# ---------------------------------------------------------------------------
# Smoke-test reduction
# ---------------------------------------------------------------------------


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model<=512, <=4 experts.

    Used by per-arch smoke tests which run a real forward/train step on CPU.
    """
    d_model = min(cfg.d_model, 256)
    num_heads = min(cfg.num_heads, 4)
    head_dim = max(d_model // num_heads, 32)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    # keep the GQA ratio when possible
    if cfg.num_kv_heads < cfg.num_heads:
        num_kv = max(1, num_heads // cfg.q_per_kv)
    changes = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        max_position=4096,
        dtype="float32",
    )
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 256),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            d_ff_dense=min(cfg.moe.d_ff_dense or 512, 512),
        )
    if cfg.mla:
        changes["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, rope_head_dim=32,
            nope_head_dim=head_dim, v_head_dim=head_dim,
        )
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_size=min(cfg.ssm.state_size, 16),
            head_dim=min(cfg.ssm.head_dim, 32), chunk_size=32,
        )
    if cfg.hybrid:
        changes["hybrid"] = dataclasses.replace(
            cfg.hybrid, shared_block_period=1, shared_window=64)
    if cfg.encdec:
        changes["encdec"] = dataclasses.replace(
            cfg.encdec, encoder_layers=2, encoder_frames=16)
    if cfg.vlm:
        changes["vlm"] = dataclasses.replace(
            cfg.vlm, cross_attn_layers=(1,), image_tokens=8,
            vision_dim=d_model)
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config: {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # import the per-arch modules exactly once
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        whisper_base, rwkv6_1p6b, yi_9b, qwen3_moe_235b_a22b,
        command_r_plus_104b, llama32_vision_11b, zamba2_2p7b,
        mistral_large_123b, deepseek_v3_671b, h2o_danube_1p8b,
    )
