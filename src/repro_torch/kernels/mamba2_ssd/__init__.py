from repro_torch.kernels.mamba2_ssd.ops import ssd, ssd_bwd
from repro_torch.kernels.mamba2_ssd.ref import ssd_bwd_plain, ssd_plain, ssd_ref

__all__ = ["ssd", "ssd_bwd", "ssd_bwd_plain", "ssd_plain", "ssd_ref"]
