"""Wrapper of the Hopper RMSNorm kernels (``csrc/rmsnorm.cu``).

``rmsnorm_fwd`` replaces the Pallas TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm``; ``rmsnorm_bwd`` computes its input
gradient, and with ``want_dg`` the gradient of ``g`` too (a model without
adapters trains its norms), which the JAX package takes from autodiff of
the XLA twin.  ``rmsnorm`` joins the two in an ``autograd.Function``.  The wrappers take
CUDA tensors only; ``kernels.ops.rmsnorm`` sends CPU tensors to the plain
version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, costs, nancheck

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
    costs.charge("rmsnorm", x, g)
    nancheck.check_output("rmsnorm", y)
    return y


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5, *, want_dg: bool = False):
    """dx of ``rmsnorm_fwd(x, g, eps)`` given dy (x's shape and dtype);
    with ``want_dg``, (dx, dg), dg of g's shape and dtype, from the same
    call."""
    global bwd_launches
    rows = _check(x, g, dy)
    dx = torch.empty_like(x)
    dg = torch.zeros_like(g) if want_dg else None
    if rows == 0:
        return (dx, dg) if want_dg else dx
    lib = build.load()
    part = None
    if want_dg:  # the dg pass's partial sums, a row of d a row group
        groups = ctypes.c_int(0)
        lib.firm_rmsnorm_dg_groups(rows, ctypes.byref(groups))
        part = torch.empty((groups.value, x.shape[-1]), dtype=torch.float32,
                           device=x.device)
    err = lib.firm_rmsnorm_bwd(
        x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dg.data_ptr() if want_dg else None,
        part.data_ptr() if want_dg else None, rows, x.shape[-1],
        float(eps), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"rmsnorm backward kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    costs.charge("rmsnorm_bwd", x, g, want_dg=want_dg)
    nancheck.check_output("rmsnorm_bwd", dx)
    if want_dg:
        nancheck.check_output("rmsnorm_bwd", dg)
        return dx, dg
    return dx


class RMSNorm(torch.autograd.Function):
    """Forward and ``dx`` through the kernels; ``dg`` too where ``g`` is
    trained (frozen on the LoRA path, it is not computed there)."""

    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return rmsnorm_fwd(x, g, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            dx, dg = rmsnorm_bwd(x, g, dy.contiguous(), ctx.eps, want_dg=True)
            return dx, dg, None
        return rmsnorm_bwd(x, g, dy.contiguous(), ctx.eps), None, None


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """``rmsnorm_fwd`` with a gradient for x through ``rmsnorm_bwd``."""
    return RMSNorm.apply(x, g, eps)
