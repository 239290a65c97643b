"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates without
sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12      # FLOP/s on the tensor cores, bf16 and fp16
TF32_FLOPS = 495e12      # FLOP/s on the tensor cores, TF32
FP32_FLOPS = 67e12       # FLOP/s on the CUDA cores
HBM_BYTES_PER_S = 3.35e12

# the peak each compute dtype is held against
FLOPS_BY_DTYPE = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
                  "float32": FP32_FLOPS}
