"""Wrapper of the Hopper RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``.  The
wrapper takes CUDA tensors only; ``kernels.ops.rmsnorm`` sends CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far; chip_smoke.py zeroes it around the main path
launches = 0


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: (..., d), g: (d,) of x's dtype -> same shape and dtype as x."""
    global launches
    if not x.is_cuda or g.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got x on {x.device} and g on {g.device}")
    if x.dtype not in DTYPES or g.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x and g "
                        f"of one dtype, got {x.dtype} and {g.dtype}")
    if x.dim() < 1 or g.shape != x.shape[-1:]:
        raise ValueError(f"g must have shape {tuple(x.shape[-1:])}, "
                         f"got {tuple(g.shape)}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and g")
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    if rows >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel takes < 2**31 rows and columns, "
                         f"got {rows} x {d}")
    err = build.load().firm_rmsnorm(
        x.data_ptr(), g.data_ptr(), y.data_ptr(), rows, d, float(eps),
        DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    launches += 1
    return y
