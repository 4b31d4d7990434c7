"""Wrapper of the Hopper Gram-matrix kernel (``csrc/gram.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/gram.py:gram_pallas``.  The
wrapper takes a CUDA tensor only; ``kernels.ops.gram`` sends CPU tensors to
the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
M_MAX = 8             # the Pallas kernel's M_PAD
N_BLOCKS = 2 * 132    # first-pass blocks: two on every SM of an H100

# kernel launches so far; chip_smoke.py zeroes it around the main path
launches = 0


def gram(x: torch.Tensor) -> torch.Tensor:
    """(M, d) f32 or bf16, M <= 8 -> (M, M) f32 ``x @ x.T``, summed in f32
    in a fixed order (the same bits on every run)."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"gram kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"gram kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= M_MAX or x.shape[1] == 0:
        raise ValueError(f"gram kernel takes (M, d) with 1 <= M <= {M_MAX} "
                         f"and d > 0, got {tuple(x.shape)}")
    if x.shape[1] >= 2 ** 31:
        raise ValueError(f"gram kernel takes d < 2**31, got {x.shape[1]}")
    if not x.is_contiguous():
        raise ValueError("gram kernel needs a contiguous x")
    m, d = x.shape
    partials = torch.empty((N_BLOCKS, m * (m + 1) // 2), dtype=torch.float32,
                           device=x.device)
    g = torch.empty((m, m), dtype=torch.float32, device=x.device)
    err = build.load().firm_gram(
        x.data_ptr(), partials.data_ptr(), g.data_ptr(), m, d, N_BLOCKS,
        DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    launches += 1
    return g
