"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit)."""

H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
