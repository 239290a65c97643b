"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24 layers, d_model=2560, 32 heads (GQA kv=8), d_ff=6912, vocab=32000,
SWA window 4096.  [arXiv:2401.16818]
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attn_kind="gqa",
    sliding_window=4096,          # native SWA
    rope_theta=10000.0,
    norm_kind="rmsnorm",
    act="swiglu",
    max_position=1 << 30,         # SWA: unbounded via window
))
