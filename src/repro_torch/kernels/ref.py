"""Plain PyTorch versions of the ported kernels (mirror ``repro.kernels.ref``).

The CPU path of the port runs these, the tests hold them against the JAX
oracles, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  The remaining oracles of ``repro.kernels.ref`` (gram, quantize,
dequantize, the threshold passes, ssd_scan) arrive with their kernels.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
