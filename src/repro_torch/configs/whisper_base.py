"""whisper-base [audio] — enc-dec transformer, conv/mel frontend stubbed.

6 encoder + 6 decoder layers, d_model=512, 8 heads (MHA, kv=8), d_ff=2048,
vocab=51865.  [arXiv:2212.04356]
"""

from repro_torch.configs.base import EncDecConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="encdec",
    source="arXiv:2212.04356",
    num_layers=6,                 # decoder layers; encoder in EncDecConfig
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    attn_kind="gqa",
    use_bias=True,
    norm_kind="layernorm",
    act="gelu",
    tie_embeddings=True,          # whisper ties decoder embed and head
    rope_theta=0.0,               # whisper uses learned/sinusoidal positions
    max_position=4096,            # synthetic extension (real model: 448)
    encdec=EncDecConfig(encoder_layers=6, encoder_frames=1500,
                        max_target_positions=448),
))
