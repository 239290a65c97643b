"""yi-9b [dense] — llama-arch GQA.

48 layers, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000.
[arXiv:2403.04652]
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    attn_kind="gqa",
    rope_theta=10000.0,
    norm_kind="rmsnorm",
    act="swiglu",
    max_position=524288,
))
