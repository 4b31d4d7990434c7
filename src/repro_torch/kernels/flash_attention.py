"""Wrapper of the Hopper GQA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_attention``.  Unlike the Pallas
kernel it takes ragged sequence lengths.  The wrapper takes CUDA tensors
only; ``kernels.ops.flash_attention`` sends CPU tensors to the plain
version in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)

# kernel launches so far; chip_smoke.py zeroes it around the main path
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, Hq, Dh)."""
    global launches
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention kernel needs CUDA q, k, v on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, Sq, Hq, Dh) and k, v (B, Skv, Hkv, "
                         f"Dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv
            or skv == 0):
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}: batch and head_dim must match, "
                         "Hq must be a multiple of Hkv and Skv > 0")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if sliding_window < 0:
        raise ValueError(f"sliding_window must be >= 0, got {sliding_window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs {name} "
                             "contiguous and 16-byte aligned")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("flash_attention kernel takes < 2**31 elements")
    err = build.load().firm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, skv,
        hq, hkv, dh, int(causal), int(sliding_window), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return o
