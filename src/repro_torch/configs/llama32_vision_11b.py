"""llama-3.2-vision-11b [vlm] — cross-attn image layers, ViT frontend stubbed.

40 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256;
cross-attention layers every 5th layer.  [hf:meta-llama/Llama-3.2-11B-Vision]
"""

from repro_torch.configs.base import ModelConfig, VLMConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    attn_kind="gqa",
    rope_theta=500_000.0,
    norm_kind="rmsnorm",
    act="swiglu",
    max_position=524288,
    vlm=VLMConfig(cross_attn_layers=(4, 9, 14, 19, 24, 29, 34, 39),
                  image_tokens=1601, vision_dim=4096),
))
