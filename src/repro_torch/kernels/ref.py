"""Plain PyTorch versions of the ported kernels (mirror ``repro.kernels.ref``).

The CPU path of the port runs these, the tests hold them against the JAX
oracles, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  ``rmsnorm_bwd`` and ``flash_attention_bwd`` are the plain versions
of the backward kernels: the gradients autograd takes of ``rmsnorm`` and
``flash_attention`` (JAX's autodiff of the same functions).
``dequantize_residual`` is the plain version of the dequantize kernel's
error-feedback epilogue.  ``abs_threshold_count`` and
``abs_threshold_mask`` also take a stack of C clients' blocks with one
threshold each.  ssd_scan, the one oracle of ``repro.kernels.ref`` left,
arrives with its kernel.
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


INV_2_32 = 2.0 ** -32


def quantize(x2: torch.Tensor, bits: torch.Tensor, qmax: int = 127):
    """Blockwise symmetric quantization, as ``repro.kernels.ref.quantize``.

    x2: (R, B) f32; bits: (R, B) int32 holding the uint32 rounding offsets'
    bit patterns (2**31 = exactly round-to-nearest).  Returns ((R, B) int8
    codes, (R, 1) f32 scales).  The bits widen through int64 to their
    unsigned value and round once to f32, as JAX's uint32 -> f32 does.  The
    scale is ``absmax * rn(1/qmax)``, not ``absmax / qmax``: XLA compiles
    the reference's division by the constant qmax as a multiply by its
    rounded reciprocal, which differs from the division in the last bit of
    about one row in 25 (int8).  ``x / scale`` stays a true division.
    """
    x = x2.float()
    absmax = x.abs().amax(dim=-1, keepdim=True)
    inv_qmax = torch.ones((), dtype=torch.float32, device=x.device) / qmax
    scale = torch.where(absmax > 0, absmax * inv_qmax,
                        torch.ones_like(absmax))
    r = (bits.long() & 0xFFFFFFFF).float() * INV_2_32
    q = torch.clamp(torch.floor(x / scale + r), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(R, B) int8 codes times their (R, 1) f32 scales, in f32."""
    return codes.float() * scales


def dequantize_residual(codes: torch.Tensor, scales: torch.Tensor,
                        adj: torch.Tensor) -> torch.Tensor:
    """The error-feedback residual ``adj - codes * scale``, rounded once.

    XLA contracts the reference's dequantize multiply into the residual
    subtract (one fused multiply-subtract), so the residual is the exact
    difference rounded to f32 once.  Here it is taken in f64: the product
    of a code (7 bits) and a scale (24 bits) is exact there, and so is the
    difference unless the two operands' exponents lie more than about 22
    binary orders apart, when f64 rounds it first (a double rounding that
    can differ from the single one in the last bit: the far-off case).
    """
    return (adj.double() - codes.double() * scales.double()).float()


def _per_client(x2: torch.Tensor, thresh) -> torch.Tensor:
    """The threshold as an f32 tensor that broadcasts over ``x2``'s last
    two axes: a scalar for (R, B), one value a client for (C, R, B)."""
    t = torch.as_tensor(thresh, dtype=torch.float32, device=x2.device)
    return t.reshape(t.shape + (1, 1))


def abs_threshold_count(x2: torch.Tensor, thresh) -> torch.Tensor:
    """Count of ``|x| >= thresh`` over each client's (R, B) blocks, as f32.

    x2: (R, B), or (C, R, B) with ``thresh`` of shape (C,).  The count is
    an exact integer rounded once to f32 (exact below 2**24, where the
    reference's f32 accumulation is exact too).
    """
    hit = x2.float().abs() >= _per_client(x2, thresh)
    return hit.sum(dim=(-2, -1)).float()


def abs_threshold_mask(x2: torch.Tensor, thresh) -> torch.Tensor:
    """``x`` where ``|x| >= thresh``, else +0.0; shapes as the count's."""
    x = x2.float()
    return torch.where(x.abs() >= _per_client(x2, thresh), x,
                       torch.zeros((), dtype=torch.float32, device=x.device))
