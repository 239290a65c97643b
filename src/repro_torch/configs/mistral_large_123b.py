"""mistral-large-123b [dense] — GQA.

88 layers, d_model=12288, 96 heads (GQA kv=8), d_ff=28672, vocab=32768.
[hf:mistralai/Mistral-Large-Instruct-2407]
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    attn_kind="gqa",
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    act="swiglu",
    max_position=524288,
))
