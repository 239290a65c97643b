"""command-r-plus-104b [dense] — GQA, no-bias, parallel attn+mlp block.

64 layers, d_model=12288, 96 heads (GQA kv=8), d_ff=33792, vocab=256000.
[hf:CohereForAI/c4ai-command-r-v01]
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    attn_kind="gqa",
    use_bias=False,
    norm_kind="layernorm",        # cohere uses LayerNorm (no bias)
    act="swiglu",
    parallel_block=True,          # cohere parallel residual
    tie_embeddings=True,          # command-r ties embeddings
    rope_theta=75_000_000.0,
    max_position=524288,
))
