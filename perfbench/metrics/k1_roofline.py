"""k1_roofline: K1's forward launches in the traced sub-window: their frozen
roofline bound over their device time."""

from perfbench.harness import readers

LAYER = "kernels (kernels/flash_attention)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "infer_rows_per_s"
# K1's forward kernels (kernels/flash_attention/csrc/flash_attention.cu):
# bf16 on wgmma, float32 TF32 x 3, and the CUDA-core kernel
K1_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_tf32_kernel",
              "flash_attention_kernel")


def read(run):
    return readers.k1_roofline_pct(run, K1_KERNELS)
