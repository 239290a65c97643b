"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP.

61 layers (first 3 dense), d_model=7168, 128 heads, expert d_ff=2048,
vocab=129280.  [arXiv:2412.19437]
"""

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,             # MLA: latent cache shared by all heads
    head_dim=128,
    d_ff=2048,                    # expert intermediate size
    vocab_size=129280,
    attn_kind="mla",
    rope_theta=10000.0,
    norm_kind="rmsnorm",
    act="swiglu",
    max_position=524288,
    mtp=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_k_dense=3, d_ff_dense=18432,
                  router_aux_weight=1e-3, norm_topk_prob=True),
))
