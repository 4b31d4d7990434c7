"""Wrapper of the Hopper SSD chunked-scan kernels (``csrc/ssd.cu``, and
the backward in ``csrc/ssd_bwd.cu``).

``ssd_scan`` replaces the Pallas TPU kernel
``repro/kernels/ssd.py:ssd_scan``, in the layout of
``repro.models.ssm.mamba2_seq``: x (B, S, nh, hd), B and C (B, S, ds)
shared by all heads, dt and da (B, S, nh), all f32; y (B, S, nh, hd) f32
and, on request, the final state (B, nh, hd, ds).  Unlike the Pallas
kernel it takes any S (the last chunk is masked) and strided inputs (x, B
and C are views into the convolution's output).  ``ssd_scan_bwd``
computes its gradients (dx, dB, dC, d(dt), d(da)) given dy and an
optional d(final state), which the JAX package takes from autodiff of the
XLA scan; ``SSDScan`` joins the two in an ``autograd.Function``.  The
wrappers take CUDA tensors only; ``kernels.ops.ssd_scan`` sends CPU
tensors to the plain version ``kernels.ref.ssd_chunked``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, costs, nancheck

CHUNK = 128          # cfg.ssm_chunk of every config
HEAD_DIM = 64        # cfg.ssm_head_dim of every config
STATE_DIMS = (16, 64)     # zamba2 and its smoke preset

# kernel launches so far (the backward counts one per call of its C entry,
# which launches its three kernels); chip_smoke.py zeroes them around the
# main path
launches = 0
bwd_launches = 0
BWD_KERNELS = 3        # kernels a call of the backward's C entry launches


def _strides(t: torch.Tensor, what: str):
    """The element strides of every axis but the last, which must be 1."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"ssd kernel needs unit stride on the last axis of "
                         f"{what}, got strides {t.stride()}")
    return [int(st) for st in t.stride()[:-1]]


def _check(x, bmat, cmat, dt, da, chunk):
    """Refuse what the kernels do not take; (B, S, nh, hd, ds, the
    element strides of x, B, C, dt and da)."""
    ts = {"x": x, "B": bmat, "C": cmat, "dt": dt, "da": da}
    if any(not t.is_cuda or t.device != x.device for t in ts.values()):
        raise ValueError("ssd kernel needs CUDA tensors on one device, got "
                         + ", ".join(f"{k} on {t.device}"
                                     for k, t in ts.items()))
    if any(t.dtype != torch.float32 for t in ts.values()):
        raise TypeError("ssd kernel takes float32 x, B, C, dt and da, got "
                        + ", ".join(f"{k} {t.dtype}" for k, t in ts.items()))
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, nh, hd), got {tuple(x.shape)}")
    b, s, nh, hd = x.shape
    ds = bmat.shape[-1]
    if (bmat.shape != (b, s, ds) or cmat.shape != (b, s, ds)
            or dt.shape != (b, s, nh) or da.shape != (b, s, nh)):
        raise ValueError(
            f"B and C must be (B, S, ds) and dt, da (B, S, nh) for x "
            f"{tuple(x.shape)}, got {tuple(bmat.shape)}, {tuple(cmat.shape)}, "
            f"{tuple(dt.shape)}, {tuple(da.shape)}")
    if hd != HEAD_DIM or ds not in STATE_DIMS or chunk != CHUNK:
        raise ValueError(f"ssd kernel takes hd = {HEAD_DIM}, ds in "
                         f"{STATE_DIMS} and chunk = {CHUNK}, got hd = {hd}, "
                         f"ds = {ds}, chunk = {chunk}")
    strides = (_strides(x, "x") + _strides(bmat, "B") + _strides(cmat, "C")
               + _strides(dt, "dt") + _strides(da, "da"))
    for k, t in ts.items():
        if sum((n - 1) * st for n, st in zip(t.shape, t.stride())) >= 2 ** 31:
            raise ValueError(f"ssd kernel takes < 2**31 elements ({k})")
    return b, s, nh, hd, ds, strides


def ssd_scan(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             dt: torch.Tensor, da: torch.Tensor, *, chunk: int = CHUNK,
             return_state: bool = False):
    """y (B, S, nh, hd) f32 of the chunked SSD scan, and with
    ``return_state`` also the final state (B, nh, hd, ds) f32."""
    global launches
    b, s, nh, hd, ds, strides = _check(x, bmat, cmat, dt, da, chunk)
    y = torch.empty((b, s, nh, hd), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        state = torch.zeros((b, nh, hd, ds), dtype=torch.float32,
                            device=x.device)
        return (y, state) if return_state else y
    if y.numel() >= 2 ** 31:
        raise ValueError("ssd kernel takes < 2**31 output elements")
    # the kernel keeps each head's state here between chunks: the output,
    # or scratch when the final state is not wanted and S spans chunks
    state = (torch.empty((b, nh, hd, ds), dtype=torch.float32,
                         device=x.device) if return_state or s > CHUNK
             else None)
    err = build.load().firm_ssd_scan(
        x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(),
        da.data_ptr(), y.data_ptr(),
        state.data_ptr() if state is not None else None, int(return_state),
        b, s, nh, ds, *strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    launches += 1
    costs.charge("ssd", x, bmat, cmat, dt, da, chunk=chunk,
                 return_state=return_state)
    nancheck.check_output("ssd", y, state if return_state else None)
    return (y, state) if return_state else y


def ssd_scan_bwd(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                 dt: torch.Tensor, da: torch.Tensor, dy: torch.Tensor,
                 dstate: Optional[torch.Tensor] = None, *,
                 chunk: int = CHUNK):
    """(dx, dB, dC, d(dt), d(da)) of ``ssd_scan`` given dy (B, S, nh, hd)
    and, if the final state was used, its gradient (B, nh, hd, ds); all
    f32 and contiguous, in the inputs' shapes."""
    global bwd_launches
    b, s, nh, hd, ds, strides = _check(x, bmat, cmat, dt, da, chunk)
    want = {"dy": (dy, (b, s, nh, hd))}
    if dstate is not None:
        want["d(final state)"] = (dstate, (b, nh, hd, ds))
    for name, (t, shape) in want.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"ssd backward needs {name} as a contiguous "
                             f"f32 {shape} tensor on x's device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, s, nh, hd), **f32)
    dbm, dcm = (torch.empty((b, s, ds), **f32) for _ in range(2))
    ddt, dda = (torch.empty((b, s, nh), **f32) for _ in range(2))
    if dx.numel() == 0:
        return dx, dbm, dcm, ddt, dda
    if dx.numel() >= 2 ** 31:
        raise ValueError("ssd kernel takes < 2**31 output elements")
    lib = build.load()
    groups = ctypes.c_int(0)
    lib.firm_ssd_bwd_groups(nh, ctypes.byref(groups))
    groups = groups.value
    nchunks = -(-s // CHUNK)
    # the chunk-start states (transposed) and the chunks' end-state
    # gradients, from the kernels' first launch
    h0t = torch.empty((b, nchunks - 1, nh, ds, hd), **f32)
    dh = torch.empty((b, nchunks - 1, nh, hd, ds), **f32)
    pdb, pdc = (torch.empty((b, groups, s, ds), **f32) for _ in range(2))
    if pdb.numel() >= 2 ** 31:
        raise ValueError("ssd backward takes < 2**31 partial elements")
    ptr = [t.data_ptr() for t in (x, bmat, cmat, dt, da, dy)]
    err = lib.firm_ssd_scan_bwd(
        *ptr, dstate.data_ptr() if dstate is not None else None,
        *(t.data_ptr() for t in (dx, dbm, dcm, ddt, dda, h0t, dh, pdb, pdc)),
        b, s, nh, ds, *strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"ssd backward kernels' launch failed: CUDA error {err}")
    bwd_launches += 1
    costs.charge("ssd_bwd", x, bmat, cmat, dt, da, chunk=chunk)
    nancheck.check_output("ssd_bwd", dx, dbm, dcm, ddt, dda)
    return dx, dbm, dcm, ddt, dda


class SSDScan(torch.autograd.Function):
    """Forward and backward through the kernels.  The forward saves its
    inputs only when a gradient will be asked for; the backward hands the
    final state's gradient on when the state was returned."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, dt, da, chunk, return_state, need_grad):
        ctx.chunk = chunk
        if need_grad:
            ctx.save_for_backward(x, bmat, cmat, dt, da)
        return ssd_scan(x, bmat, cmat, dt, da, chunk=chunk,
                        return_state=return_state)

    @staticmethod
    def backward(ctx, dy, dstate=None):
        x, bmat, cmat, dt, da = ctx.saved_tensors
        grads = ssd_scan_bwd(
            x, bmat, cmat, dt, da, dy.contiguous(),
            None if dstate is None else dstate.contiguous(), chunk=ctx.chunk)
        return grads + (None, None, None)


def ssd_scan_trainable(x: torch.Tensor, bmat: torch.Tensor,
                       cmat: torch.Tensor, dt: torch.Tensor,
                       da: torch.Tensor, *, chunk: int = CHUNK,
                       return_state: bool = False):
    """``ssd_scan`` with gradients for every input through
    ``ssd_scan_bwd``."""
    need_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, bmat, cmat, dt, da))
    return SSDScan.apply(x, bmat, cmat, dt, da, chunk, return_state,
                         need_grad)


def occupancy(ds: int, backward: bool = False) -> dict:
    """The scan kernel's (or with ``backward`` the backward's chunk
    kernel's) blocks an SM on this card and its shared memory a block, for
    state dimension ``ds`` (a query, not a launch)."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib = build.load()
    query = lib.firm_ssd_bwd_occupancy if backward else lib.firm_ssd_occupancy
    err = query(ds, ctypes.byref(blocks), ctypes.byref(smem))
    if err:
        raise RuntimeError(f"ssd occupancy query failed: CUDA error {err}")
    return {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}
