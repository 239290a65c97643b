"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

54 layers, d_model=2560, 32 heads (kv=32, MHA in the shared block),
d_ff=10240, ssm_state=64.  [arXiv:2411.15242]
"""

from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    attn_kind="gqa",              # used by the shared block
    norm_kind="rmsnorm",
    act="gelu",                   # zamba2 shared block uses gelu MLP
    rope_theta=10000.0,
    max_position=1 << 30,         # SSM backbone: unbounded
    ssm=SSMConfig(kind="mamba2", state_size=64, head_dim=64, expand=2,
                  conv_kernel=4, chunk_size=128),
    hybrid=HybridConfig(shared_block_period=6, shared_window=4096),
))
