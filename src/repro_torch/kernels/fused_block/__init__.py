from repro_torch.kernels.fused_block.ops import VEC, rms_norm, rope_qk, silu_mul
from repro_torch.kernels.fused_block.ref import (rms_norm_plain, rope_plain,
                                                 rope_qk_plain,
                                                 silu_mul_plain)

__all__ = ["VEC", "rms_norm", "rms_norm_plain", "rope_plain", "rope_qk",
           "rope_qk_plain", "silu_mul", "silu_mul_plain"]
