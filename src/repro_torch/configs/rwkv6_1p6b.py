"""rwkv6-1.6b [ssm] — Finch, attention-free, data-dependent decay.

24 layers, d_model=2048, d_ff=7168, vocab=65536.  [arXiv:2404.05892]
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=32,                 # rwkv6 head_size=64 -> 2048/64
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    attn_kind="none",
    norm_kind="layernorm",        # rwkv uses LayerNorm
    act="relu_sq",                # rwkv channel-mix uses relu^2
    max_position=1 << 30,         # recurrent: unbounded context
    ssm=SSMConfig(kind="rwkv6", state_size=64, head_dim=64, chunk_size=128),
))
