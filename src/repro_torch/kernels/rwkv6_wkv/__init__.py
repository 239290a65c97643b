from repro_torch.kernels.rwkv6_wkv.ops import wkv6, wkv6_bwd
from repro_torch.kernels.rwkv6_wkv.ref import (wkv6_bwd_plain, wkv6_plain,
                                             wkv6_ref)

__all__ = ["wkv6", "wkv6_bwd", "wkv6_bwd_plain", "wkv6_plain", "wkv6_ref"]
