"""Wrappers of the Hopper kernels of the codecs: quantize and dequantize
(``csrc/quantize.cu``), and the top-k threshold count and mask
(``csrc/threshold.cu``).

Replace the Pallas TPU kernels of ``repro/kernels/quantize.py``:
``quantize``, ``dequantize``, ``abs_threshold_count`` and
``abs_threshold_mask``.  The wrappers take CUDA tensors only;
``kernels.ops`` sends CPU tensors to the plain versions in
``kernels.ref``.  Rounding bits travel as int32 tensors holding the uint32
bit patterns (``torch.uint32`` has few operations); the kernel reads them
as uint32.  The threshold passes take one client's (R, 1024) blocks with
a 0-d threshold, or C clients' (C, R, 1024) with a (C,) threshold, both on
the device, so that a bisection never waits for the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, costs, nancheck

BLOCK = 1024          # elements per row: one scale each

# kernel launches so far; chip_smoke.py zeroes them around the main path
quantize_launches = 0
dequantize_launches = 0
threshold_count_launches = 0
threshold_mask_launches = 0


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
    costs.charge("quantize", x, bits)
    nancheck.check_output("quantize", scales)
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
    costs.charge("dequantize", codes, scales, adj)
    nancheck.check_output("dequantize", out, residual)
    return out, residual


def _threshold_args(x: torch.Tensor, thresh: torch.Tensor):
    """Check a threshold pass's inputs: (clients, rows a client)."""
    if not x.is_cuda:
        raise ValueError(f"threshold kernels need CUDA tensors; x is on "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() not in (2, 3) or x.shape[-1] != BLOCK or 0 in x.shape:
        raise ValueError(f"x must be (rows, {BLOCK}) or (clients, rows, "
                         f"{BLOCK}) with no empty axis, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    clients, rows = (x.shape[0] if x.dim() == 3 else 1), x.shape[-2]
    if clients > 65535 or rows >= 2 ** 22:
        raise ValueError(f"x {tuple(x.shape)}: at most 65535 clients of "
                         f"fewer than 2**22 rows (2**32 elements)")
    if (not isinstance(thresh, torch.Tensor) or thresh.device != x.device
            or thresh.dtype != torch.float32
            or tuple(thresh.shape) != tuple(x.shape[:-2])
            or not thresh.is_contiguous()):
        raise ValueError(f"thresh must be a contiguous float32 tensor of "
                         f"shape {tuple(x.shape[:-2])} on {x.device}")
    return clients, rows


def abs_threshold_count(x: torch.Tensor, thresh: torch.Tensor):
    """Count of ``|x| >= thresh`` a client, as f32, shaped like ``thresh``:
    the same values as ``ref.abs_threshold_count``."""
    global threshold_count_launches
    clients, rows = _threshold_args(x, thresh)
    scratch = torch.zeros(2 * clients, dtype=torch.int32, device=x.device)
    out = torch.empty(thresh.shape, dtype=torch.float32, device=x.device)
    err = build.load().firm_abs_threshold_count(
        x.data_ptr(), thresh.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        clients, rows, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"threshold count kernel launch failed: CUDA "
                           f"error {err}")
    threshold_count_launches += 1
    costs.charge("abs_threshold_count", x, thresh)
    return out


def abs_threshold_mask(x: torch.Tensor, thresh: torch.Tensor):
    """``x`` where ``|x| >= thresh``, else +0.0: the same bits as
    ``ref.abs_threshold_mask``."""
    global threshold_mask_launches
    clients, rows = _threshold_args(x, thresh)
    out = torch.empty_like(x)
    err = build.load().firm_abs_threshold_mask(
        x.data_ptr(), thresh.data_ptr(), out.data_ptr(), clients, rows,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"threshold mask kernel launch failed: CUDA "
                           f"error {err}")
    threshold_mask_launches += 1
    costs.charge("abs_threshold_mask", x, thresh)
    return out
