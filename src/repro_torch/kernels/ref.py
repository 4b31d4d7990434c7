"""Plain PyTorch versions of the ported kernels (mirror ``repro.kernels.ref``).

The CPU path of the port runs these, the tests hold them against the JAX
oracles, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  ``rmsnorm_bwd`` and ``flash_attention_bwd`` are the plain versions
of the backward kernels: the gradients autograd takes of ``rmsnorm`` and
``flash_attention`` (JAX's autodiff of the same functions).  The remaining
oracles of ``repro.kernels.ref`` (quantize, dequantize, the threshold
passes, ssd_scan) arrive with their kernels.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gram(x: torch.Tensor) -> torch.Tensor:
    """(M, d) -> (M, M) Gram matrix, f32 accumulation."""
    xf = x.float()
    return xf @ xf.T


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, Hq, Dh).

    Naive materialised softmax attention in f32; query i and key j sit at
    absolute positions i and j.
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qpk = hq // hkv
    kx = k.repeat_interleave(qpk, dim=2).float()
    vx = v.repeat_interleave(qpk, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * dh ** -0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if sliding_window:
        mask &= qp - kp < sliding_window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx)
    return o.to(q.dtype)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """Normalise in f32, round to ``x.dtype``, then scale by ``g``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """dx of ``rmsnorm(x, g, eps)`` given dy; no dg (g is frozen).

    ``dy * g`` is rounded to ``x.dtype``, as autograd's product is, and the
    rest runs in f32: ``r * (dn - n * mean(dn * n))`` with ``n = x * r``.
    """
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    n = xf * r
    dn = (dy * g).float()
    return (r * (dn - n * torch.mean(dn * n, dim=-1, keepdim=True))
            ).to(x.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        sliding_window: int = 0):
    """(dq, dk, dv) of ``flash_attention`` given the output gradient ``do``:
    autograd of the plain forward in f32, cast to the inputs' dtype."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        o = flash_attention(qf, kf, vf, causal=causal,
                            sliding_window=sliding_window)
        dq, dk, dv = torch.autograd.grad(o, (qf, kf, vf), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
