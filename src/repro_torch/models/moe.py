"""Mixture-of-Experts FFN: GShard einsum dispatch with capacity and dropping.

Counterpart of ``repro.models.moe``, with its arithmetic in its order.
Routing builds a (S*k, E, cap) one-hot dispatch tensor per batch row and
moves tokens with einsums only:

  buf  = einsum('bsec,bsd->becd', dispatch, x)      # tokens -> expert rows
  y    = einsum('bsec,becd->bsd', combine,  out)    # expert rows -> tokens

The JAX package computes these products, and the experts' SwiGLU, outside
any Pallas kernel (XLA's dots), so here they are ``torch.einsum``s too.

Capacity is per batch row: ``cap = round_up(max(k, int(S k / E cf)), 8)``
is a Python int from the shapes (80 at the update's S = 256 for
mixtral-8x7b, 40 at a prefill of 128, 8 in a decode step), and a token's
choice past its expert's capacity is dropped, with priority (s, k) over
the row's flattened (S k) axis.  A teacher-forced forward and a decode
step therefore route differently by design, as in the reference.

Both one-hots (expert choice and slot) are built by comparison with
``arange``: ``jax.nn.one_hot`` gives a zero row for a slot >= cap, where
``torch.nn.functional.one_hot`` raises after a range check that reads the
tensor back to the host, which a captured decode step or update may not
do.  ``torch.topk`` returns the k largest probabilities in descending
order, as ``jax.lax.top_k`` does, but promises no order among equal
probabilities; with f32 router logits of random inputs ties do not occur.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def init_moe(cfg: ModelConfig, *, generator: torch.Generator, device,
             dtype=torch.bfloat16, lead: tuple = ()) -> dict:
    """The router (f32, as in the reference) and E experts' SwiGLU weights
    in ``dtype``; ``lead`` prepends stacking axes.  All of it is frozen:
    adapters live on the attention projections only."""
    d, dff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    kw = dict(generator=generator, device=device)
    scale = 1.0 / math.sqrt(d)
    return {
        "router": {"w": common.normal(lead + (d, e), scale, torch.float32,
                                      **kw)},
        "experts": {
            "w_gate": common.normal(lead + (e, d, dff), scale, dtype, **kw),
            "w_up": common.normal(lead + (e, d, dff), scale, dtype, **kw),
            "w_down": common.normal(lead + (e, dff, d), 1.0 / math.sqrt(dff),
                                    dtype, **kw),
        },
    }


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots an expert has in a batch row of ``s`` tokens: the reference's
    ``int()`` of a non-negative Python float, i.e. its floor."""
    moe = cfg.moe
    return _round_up(max(moe.top_k, math.floor(
        s * moe.top_k / moe.n_experts * moe.capacity_factor)), 8)


def _one_hot(x: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row where x is not in [0, n)."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, S, d) -> (y (B, S, d), aux_loss: f32 scalar)."""
    moe = cfg.moe
    e, k = moe.n_experts, moe.top_k
    b, s, d = x.shape

    logits = x.float() @ p["router"]["w"]                         # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_ids = torch.topk(probs, k, dim=-1)               # (B, S, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux (Switch): E * sum_e mean(route frac) * mean(prob)
    onehot = _one_hot(expert_ids, e, torch.float32)               # (B,S,k,E)
    frac = onehot.sum(dim=(0, 1, 2)) / (b * s * k)
    aux = moe.router_aux_weight * e * torch.sum(frac * probs.mean(dim=(0, 1)))

    cap = capacity(cfg, s)
    # position of each (token, choice) within its expert, priority (s, k);
    # the (T, E, cap) one-hots in the activation dtype, as the reference
    mask = onehot.reshape(b, s * k, e)                            # (B,T,E)
    pos = torch.cumsum(mask, dim=1) - mask                        # (B,T,E)
    within = mask * (pos < cap)                                   # keep/drop
    pos_oh = _one_hot(pos, cap, x.dtype)                          # (B,T,E,cap)
    dispatch = within[..., None].to(x.dtype) * pos_oh
    gate_flat = gate.reshape(b, s * k).to(x.dtype)
    combine = dispatch * gate_flat[:, :, None, None]

    # fold the k choices back onto tokens: (B, T=S*k, ...) -> (B,S,k,...)
    disp_tok = dispatch.reshape(b, s, k, e, cap).sum(2)           # (B,S,E,cap)
    comb_tok = combine.reshape(b, s, k, e, cap).sum(2)

    buf = torch.einsum("bsec,bsd->becd", disp_tok, x)

    w = p["experts"]
    g = torch.einsum("becd,edf->becf", buf, w["w_gate"])
    u = torch.einsum("becd,edf->becf", buf, w["w_up"])
    h = torch.nn.functional.silu(g.float()).to(buf.dtype) * u
    out = torch.einsum("becf,efd->becd", h, w["w_down"])          # (B,E,cap,d)

    y = torch.einsum("bsec,becd->bsd", comb_tok.to(out.dtype), out)
    return y.to(x.dtype), aux
