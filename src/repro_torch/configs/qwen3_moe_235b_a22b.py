"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, qk-norm.

94 layers, d_model=4096, 64 heads (GQA kv=4), expert d_ff=1536,
vocab=151936.  [hf:Qwen/Qwen3-30B-A3B scaled per assignment]
"""

from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                    # expert intermediate size
    vocab_size=151936,
    attn_kind="gqa",
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    act="swiglu",
    max_position=524288,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536,
                  num_shared_experts=0, norm_topk_prob=True),
))
