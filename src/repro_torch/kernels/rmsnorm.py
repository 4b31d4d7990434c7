"""Wrapper of the Hopper RMSNorm kernels (``csrc/rmsnorm.cu``).

``rmsnorm_fwd`` replaces the Pallas TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm``; ``rmsnorm_bwd`` computes its input
gradient, which the JAX package takes from autodiff of the XLA twin.
``rmsnorm`` joins the two in an ``autograd.Function``.  The wrappers take
CUDA tensors only; ``kernels.ops.rmsnorm`` sends CPU tensors to the plain
version in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far; chip_smoke.py zeroes them around the main path
launches = 0
bwd_launches = 0


def _check(x: torch.Tensor, g: torch.Tensor, *more: torch.Tensor) -> int:
    """Validate the operands; returns the row count."""
    if not x.is_cuda or any(t.device != x.device for t in (g, *more)):
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got x on {x.device} and g on {g.device}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (g, *more)):
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x and g "
                        f"of one dtype, got {x.dtype} and {g.dtype}")
    if x.dim() < 1 or g.shape != x.shape[-1:]:
        raise ValueError(f"g must have shape {tuple(x.shape[-1:])}, "
                         f"got {tuple(g.shape)}")
    if any(t.shape != x.shape for t in more):
        raise ValueError("dy must have x's shape")
    if not all(t.is_contiguous() for t in (x, g, *more)):
        raise ValueError("rmsnorm kernel needs contiguous tensors")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel takes < 2**31 rows and columns, "
                         f"got {rows} x {d}")
    return rows


def rmsnorm_fwd(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    """x: (..., d), g: (d,) of x's dtype -> same shape and dtype as x."""
    global launches
    rows = _check(x, g)
    y = torch.empty_like(x)
    if rows == 0:
        return y
    err = build.load().firm_rmsnorm(
        x.data_ptr(), g.data_ptr(), y.data_ptr(), rows, x.shape[-1],
        float(eps), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """dx of ``rmsnorm_fwd(x, g, eps)`` given dy (x's shape and dtype)."""
    global bwd_launches
    rows = _check(x, g, dy)
    dx = torch.empty_like(x)
    if rows == 0:
        return dx
    err = build.load().firm_rmsnorm_bwd(
        x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(), rows,
        x.shape[-1], float(eps), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"rmsnorm backward kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx


class RMSNorm(torch.autograd.Function):
    """Forward and ``dx`` through the kernels.  ``g`` is frozen on the LoRA
    path; a backward that asks for ``dg`` raises."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return rmsnorm_fwd(x, g, eps)

    @staticmethod
    def backward(ctx, dy):
        if ctx.needs_input_grad[1]:
            raise NotImplementedError(
                "the rmsnorm kernel computes no gradient for g, which is "
                "frozen on the LoRA path")
        x, g = ctx.saved_tensors
        return rmsnorm_bwd(x, g, dy.contiguous(), ctx.eps), None, None


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """``rmsnorm_fwd`` with a gradient for x through ``rmsnorm_bwd``."""
    return RMSNorm.apply(x, g, eps)
