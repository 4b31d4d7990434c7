"""Wrappers of the Hopper quantize and dequantize kernels
(``csrc/quantize.cu``).

Replace the Pallas TPU kernels ``repro/kernels/quantize.py:quantize`` and
``:dequantize``.  The wrappers take CUDA tensors only; ``kernels.ops``
sends CPU tensors to the plain versions in ``kernels.ref``.  Rounding bits
travel as int32 tensors holding the uint32 bit patterns (``torch.uint32``
has few operations); the kernel reads them as uint32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCK = 1024          # elements per row: one scale each

# kernel launches so far; chip_smoke.py zeroes them around the main path
quantize_launches = 0
dequantize_launches = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"quantize kernels need CUDA tensors; {name} is on "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] == 0 or t.shape[1] != BLOCK:
        raise ValueError(f"{name} must be (rows, {BLOCK}) with rows > 0, "
                         f"got {tuple(t.shape)}")
    if t.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has {t.shape[0]} rows; at most 2**31 - 1")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def quantize(x: torch.Tensor, bits: torch.Tensor, qmax: int = 127):
    """(R, 1024) f32 + (R, 1024) int32 bit patterns -> ((R, 1024) int8
    codes, (R, 1) f32 scales), the same bits as ``ref.quantize``."""
    global quantize_launches
    _check(x, "x", torch.float32)
    _check(bits, "bits", torch.int32)
    if bits.shape != x.shape or bits.device != x.device:
        raise ValueError(f"bits {tuple(bits.shape)} on {bits.device} must "
                         f"match x {tuple(x.shape)} on {x.device}")
    if qmax not in (7, 127):
        raise ValueError(f"qmax must be 7 (int4) or 127 (int8), got {qmax}")
    rows = x.shape[0]
    codes = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    err = build.load().firm_quantize(
        x.data_ptr(), bits.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        rows, qmax, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    quantize_launches += 1
    return codes, scales


def dequantize(codes: torch.Tensor, scales: torch.Tensor,
               adj: torch.Tensor | None = None):
    """(R, 1024) int8 codes, (R, 1) f32 scales -> (decoded, residual).

    decoded is ``codes * scale`` in f32.  Given ``adj`` ((R, 1024) f32, the
    quantized input), the same launch also writes the error-feedback
    residual ``fma(-code, scale, adj)``; otherwise residual is None.
    """
    global dequantize_launches
    _check(codes, "codes", torch.int8)
    rows = codes.shape[0]
    if (not scales.is_cuda or scales.dtype != torch.float32
            or tuple(scales.shape) != (rows, 1) or not scales.is_contiguous()
            or scales.device != codes.device):
        raise ValueError(f"scales must be contiguous ({rows}, 1) float32 on "
                         f"{codes.device}, got {tuple(scales.shape)} "
                         f"{scales.dtype} on {scales.device}")
    out = torch.empty((rows, BLOCK), dtype=torch.float32, device=codes.device)
    residual = None
    if adj is not None:
        _check(adj, "adj", torch.float32)
        if adj.shape != codes.shape or adj.device != codes.device:
            raise ValueError(f"adj {tuple(adj.shape)} must match codes "
                             f"{tuple(codes.shape)} on {codes.device}")
        residual = torch.empty_like(out)
    err = build.load().firm_dequantize(
        codes.data_ptr(), scales.data_ptr(),
        None if adj is None else adj.data_ptr(), out.data_ptr(),
        None if residual is None else residual.data_ptr(), rows,
        torch.cuda.current_stream(codes.device).cuda_stream)
    if err:
        raise RuntimeError(f"dequantize kernel launch failed: CUDA error "
                           f"{err}")
    dequantize_launches += 1
    return out, residual
