"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at its full 700 W)."""

FLOPS = {"bf16": 989e12, "fp8": 1979e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12
HBM_BYTES = 80e9
