"""Mamba2 (SSD — state-space duality) block.

Counterpart of ``repro.models.ssm``.  The sequence forward runs the
chunked SSD scan through ``kernels.ops.ssd_scan`` (the Hopper kernel on
CUDA; on the CPU its plain version ``ref.ssd_chunked``, which is the
reference's chunk body); decode is the exact single-step recurrence in
plain PyTorch.  The D skip and the ``silu(z)`` gate stay outside the
kernel, as in the reference.  Gradients: on the CPU autograd differentiates
the plain version; on CUDA ``ops.ssd_scan`` is an ``autograd.Function``
whose backward runs the SSD backward kernels, and a layer none of whose
inputs needs a gradient (the Mamba2 layers before the first trainable
adapter) saves nothing for it and launches none.

The rounding follows the reference's: the sequence-mode convolution runs
in the projection's dtype (bf16 products and sums, plus ``conv_b``) and
is cast to f32 for the SiLU; the decode convolution runs in f32, because
its history is f32.  The decode cache is updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common


def dims(cfg: ModelConfig):
    din = cfg.ssm_expand * cfg.d_model
    nheads = max(1, din // cfg.ssm_head_dim)
    return din, nheads, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2(cfg: ModelConfig, *, generator: torch.Generator, device,
                dtype=torch.bfloat16, lead: tuple = ()):
    """Random Mamba2 parameters with the reference's tree and values
    (A_log = log(linspace(1, 16, nh)), D = 1, dt_bias = 0, conv_b = 0);
    ``lead`` prepends stacking axes to each leaf."""
    d = cfg.d_model
    din, nh, hd, ds = dims(cfg)
    conv_ch = din + 2 * ds
    kw = dict(generator=generator, device=device, dtype=dtype, lead=lead)

    def const(v: torch.Tensor, dt=torch.float32):
        return v.to(device=device, dtype=dt).expand(lead + v.shape).clone()

    return {
        "ln": common.init_norm(d, device=device, dtype=dtype, lead=lead),
        # in_proj -> [z(din), x(din), B(ds), C(ds), dt(nh)]
        "in_proj": common.init_linear(d, 2 * din + 2 * ds + nh, **kw),
        "conv_w": common.normal(lead + (cfg.conv_dim, conv_ch),
                                1.0 / cfg.conv_dim, dtype,
                                generator=generator, device=device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh,
                                                dtype=torch.float32))),
        "D": const(torch.ones(nh, dtype=torch.float32)),
        "dt_bias": const(torch.zeros(nh, dtype=torch.float32)),
        "out_proj": common.init_linear(din, d, **kw),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    din, nh, hd, ds = dims(cfg)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * ds]
    dt = zxbcdt[..., din + din + 2 * ds:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, xbc: (B, S, C); w: (K, C).  Products and
    sums in xbc's dtype, then ``+ b`` and SiLU in f32: XLA fuses the
    reference's ``(out + b).astype(f32)`` and adds in f32 without
    rounding the sum to bf16."""
    k, s = w.shape[0], xbc.shape[1]
    pad = torch.cat([xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2])),
                     xbc], dim=1)
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out.float() + b.float())


def mamba2_seq(p, cfg: ModelConfig, x: torch.Tensor,
               return_state: bool = False, *, use_kernel: bool = True):
    """Full-sequence forward.  x: (B, S, d) -> (B, S, d) [, final cache]."""
    din, nh, hd, ds = dims(cfg)
    b, s, _ = x.shape
    h = common.rms_norm(p["ln"], x, cfg.norm_eps, use_kernel=use_kernel)
    z, xbc, dt_raw = _split_proj(cfg, common.linear(p["in_proj"], h))
    xbc_raw = xbc                                              # pre-conv (cache)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])          # (B,S,din+2ds) f32
    xs = xbc[..., :din].reshape(b, s, nh, hd)                  # a strided view
    bmat = xbc[..., din:din + ds]                              # (B,S,ds)
    cmat = xbc[..., din + ds:]                                 # (B,S,ds)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])             # (B,S,nh)
    a = -torch.exp(p["A_log"])                                 # (nh,) < 0
    da = dt * a                                                # log-decay
    scan = ops.ssd_scan(xs, bmat, cmat, dt, da, chunk=cfg.ssm_chunk,
                        return_state=return_state, use_kernel=use_kernel)
    y, state_f = scan if return_state else (scan, None)
    y = y + xs * p["D"][None, None, :, None]
    y = (y * F.silu(z.float()).reshape(b, s, nh, hd)).reshape(b, s, din)
    out = common.linear(p["out_proj"], y.to(x.dtype))
    if return_state:
        # conv cache: last (conv_dim-1) raw (pre-conv, pre-silu) channels
        kconv = cfg.conv_dim - 1
        hist = xbc_raw[:, -kconv:].to(torch.float32, copy=True)
        if s < kconv:
            hist = torch.cat([hist.new_zeros((b, kconv - s, hist.shape[2])),
                              hist], dim=1)
        return x + out, {"conv": hist, "state": state_f}
    return x + out


def init_mamba2_cache(cfg: ModelConfig, batch: int, *, device,
                      lead: tuple = ()):
    """A zero f32 conv history and state; ``lead`` prepends stacking
    axes."""
    din, nh, hd, ds = dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv_dim - 1, din + 2 * ds),
                            dtype=torch.float32, device=device),
        "state": torch.zeros(lead + (batch, nh, hd, ds), dtype=torch.float32,
                             device=device),
    }


def mamba2_decode(p, cfg: ModelConfig, x: torch.Tensor, cache):
    """One step.  x: (B, 1, d) -> (y (B, 1, d), cache); the cache's
    ``conv`` and ``state`` are updated in place.  It reads nothing back to
    the host and allocates only through PyTorch (the ``cat`` of the conv
    history included), so a captured decode step holds it."""
    din, nh, hd, ds = dims(cfg)
    b = x.shape[0]
    h = common.rms_norm(p["ln"], x, cfg.norm_eps)
    z, xbc, dt_raw = _split_proj(cfg, common.linear(p["in_proj"], h))
    xbc = xbc[:, 0]                                             # (B, C)
    hist = torch.cat([cache["conv"],
                      xbc[:, None].to(cache["conv"].dtype)], dim=1)
    conv = (hist * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
    xbc = F.silu(conv.float())
    xst = xbc[:, :din].reshape(b, nh, hd)
    bmat = xbc[:, din:din + ds]
    cmat = xbc[:, din + ds:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a)                                      # (B, nh)
    state = cache["state"] * da[:, :, None, None] + \
        (xst * dt[..., None])[..., None] * bmat[:, None, None, :]
    y = torch.einsum("bhds,bs->bhd", state, cmat) + \
        xst * p["D"][None, :, None]
    y = y * F.silu(z[:, 0].float()).reshape(b, nh, hd)
    out = common.linear(p["out_proj"], y.reshape(b, 1, din).to(x.dtype))
    cache["conv"].copy_(hist[:, 1:])
    cache["state"].copy_(state)
    return x + out, cache
