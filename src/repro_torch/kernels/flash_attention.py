"""Wrapper of the Hopper GQA flash-attention kernels (``csrc/flash_attention.cu``).

``flash_attention_fwd`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_attention``; unlike the Pallas
kernel it takes ragged sequence lengths.  ``flash_attention_bwd`` computes
its gradients, which the JAX package takes from autodiff of the XLA twin.
``flash_attention`` joins the two in an ``autograd.Function``.  The
wrappers take CUDA tensors only; ``kernels.ops.flash_attention`` sends CPU
tensors to the plain version in ``kernels.ref``.  The C entries pick the
kernel by dtype (``PATHS``): bf16 runs the tensor-core kernels, f32 the
FMA kernels.  Every head dim of ``HEAD_DIMS`` has its instances of all six
kernels; their tiles live in dynamic shared memory, which the C entry
allows once for each instance and whose refusal comes back as the launch
error that ``flash_attention_fwd``/``flash_attention_bwd`` raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, costs, nancheck

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels each dtype's C entry launches (csrc/flash_attention.cu)
PATHS = {torch.float32: "fma", torch.bfloat16: "tensor-core"}
HEAD_DIMS = (16, 32, 64, 128)

# kernel launches so far (the backward counts one per call of its C entry,
# which launches its two kernels); chip_smoke.py zeroes them around the
# main path
launches = 0
bwd_launches = 0


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                sliding_window: int, *more: torch.Tensor) -> None:
    """Refuse dtypes, shapes and windows the kernels do not take, on any
    device."""
    if q.dtype not in DTYPES or any(t.dtype != q.dtype
                                    for t in (k, v, *more)):
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
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("flash_attention kernel takes < 2**31 elements")


def _check_device(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *more: torch.Tensor) -> None:
    """Refuse tensors that are not on one CUDA device, contiguous and
    16-byte aligned."""
    if not q.is_cuda or any(t.device != q.device for t in (k, v, *more)):
        raise ValueError("flash_attention kernel needs CUDA q, k, v on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(
            (f"operand {i}", t) for i, t in enumerate(more)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs {name} "
                             "contiguous and 16-byte aligned")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sliding_window: int = 0,
                        with_lse: bool = False):
    """q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh) -> o (B, Sq, Hq, Dh).

    With ``with_lse`` returns ``(o, lse)``, lse the (B, Hq, Sq) f32
    log-sum-exp of the scaled scores that the backward reads.
    """
    global launches
    _check_args(q, k, v, sliding_window)
    _check_device(q, k, v)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse: Optional[torch.Tensor] = (
        torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        if with_lse else None)
    if o.numel():
        err = build.load().firm_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None, b, sq, skv, hq, hkv,
            dh, int(causal), int(sliding_window), DTYPES[q.dtype], _stream(q))
        if err:
            raise RuntimeError(
                f"flash_attention kernel launch failed: CUDA error {err}")
        launches += 1
        costs.charge("flash_attention", q, k, v, causal=causal,
                     sliding_window=sliding_window)
        nancheck.check_output("flash_attention", o, lse)
    return (o, lse) if with_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        sliding_window: int = 0):
    """(dq, dk, dv) of ``flash_attention_fwd`` given its o and lse and the
    output gradient ``do`` (o's shape and dtype)."""
    global bwd_launches
    _check_args(q, k, v, sliding_window, o, do)
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must have q's shape")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous (B, Hq, Sq) = "
                         f"{(b, hq, sq)} f32 tensor on q's device")
    if sliding_window and sq >= skv + sliding_window:
        raise ValueError(
            f"query rows past Skv + window - 2 = {skv + sliding_window - 2} "
            f"see no key (Sq = {sq}); the backward kernel does not take them")
    _check_device(q, k, v, o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    dsum = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    err = build.load().firm_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv, dh, int(causal),
        int(sliding_window), DTYPES[q.dtype], _stream(q))
    if err:
        raise RuntimeError(
            f"flash_attention backward kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    costs.charge("flash_attention_bwd", q, k, v, causal=causal,
                 sliding_window=sliding_window)
    nancheck.check_output("flash_attention_bwd", dq, dk, dv)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward and backward through the kernels; the forward keeps the
    log-sum-exp only when a gradient will be asked for."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, need_grad):
        ctx.causal, ctx.sliding_window = causal, sliding_window
        if not need_grad:
            return flash_attention_fwd(q, k, v, causal=causal,
                                       sliding_window=sliding_window)
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sliding_window=sliding_window,
                                     with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            sliding_window=ctx.sliding_window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """``flash_attention_fwd`` with gradients through
    ``flash_attention_bwd``."""
    need_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, sliding_window, need_grad)
