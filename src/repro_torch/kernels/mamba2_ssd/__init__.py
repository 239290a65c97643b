from repro_torch.kernels.mamba2_ssd.ops import ssd
from repro_torch.kernels.mamba2_ssd.ref import ssd_plain, ssd_ref

__all__ = ["ssd", "ssd_plain", "ssd_ref"]
