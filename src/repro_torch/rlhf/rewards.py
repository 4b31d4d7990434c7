"""Synthetic reward models (counterpart of ``repro.rlhf.rewards``).

Helpfulness rewards response tokens inside a "helpful" id band that
overlaps a "harmful" band, so pushing helpfulness up drags harmlessness
down; conciseness penalises length beyond a tolerance and rewards distinct
tokens.  All rewards lie in [0, 1].  ``init_learned_rm`` and
``learned_rm_score`` are the stand-in learned reward model: a frozen mean
embedding scored by a fixed direction.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch import device as device_lib

Band = Tuple[int, int]


def _band(vocab: int, lo: float, hi: float) -> Band:
    return int(vocab * lo), int(vocab * hi)


def _frac_in_band(tokens: torch.Tensor, mask: torch.Tensor,
                  band) -> torch.Tensor:
    inb = ((tokens >= band[0]) & (tokens < band[1])).float()
    n = torch.clamp(mask.sum(-1), min=1.0)
    return (inb * mask).sum(-1) / n


def helpfulness_reward(tokens, mask, band):
    # concave in the helpful fraction: diminishing returns, in [0,1]
    f = _frac_in_band(tokens, mask, band)
    return torch.sqrt(torch.clamp(f, 0.0, 1.0))


def harmlessness_reward(tokens, mask, band):
    f = _frac_in_band(tokens, mask, band)
    return torch.clamp(1.0 - 2.0 * f, 0.0, 1.0)


def conciseness_reward(tokens, mask, length_tolerance: int):
    # length penalty (paper A.2.3) + the distinct-token fraction
    n = mask.sum(-1)
    over = torch.clamp(n - length_tolerance, min=0.0)
    length_term = torch.clamp(
        1.0 - over / max(length_tolerance, 1.0), 0.0, 1.0)
    tok = torch.where(mask > 0, tokens, -1)
    same = (tok[:, :, None] == tok[:, None, :]) & (tok[:, :, None] >= 0)
    repeats = same.sum(-1).float()                          # (B, S)
    distinct = (mask / torch.clamp(repeats, min=1.0)).sum(-1) / \
        torch.clamp(n, min=1.0)
    return torch.clamp(0.5 * length_term + 0.5 * distinct, 0.0, 1.0)


def variant_bands(vocab: int, variant: str = "default") -> Tuple[Band, Band]:
    """(helpful, harmful) band edges as (lo, hi) int pairs."""
    if variant == "alt":
        return _band(vocab, 0.30, 0.55), _band(vocab, 0.42, 0.60)
    return _band(vocab, 0.25, 0.50), _band(vocab, 0.45, 0.55)


def make_reward_fns(vocab: int, n_objectives: int = 2,
                    variant: str = "default",
                    length_tolerance: int = 24) -> Sequence[Callable]:
    """M callables (tokens, mask) -> (B,) rewards in [0, 1]."""
    helpful, harmful = variant_bands(vocab, variant)
    fns = [lambda t, m: helpfulness_reward(t, m, helpful),
           lambda t, m: harmlessness_reward(t, m, harmful),
           lambda t, m: conciseness_reward(t, m, length_tolerance)]
    if n_objectives > len(fns):
        raise ValueError(f"at most {len(fns)} synthetic objectives")
    return fns[:n_objectives]


def score_batch(reward_fns: Sequence[Callable], tokens: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens/mask -> (B, M) rewards."""
    return torch.stack([f(tokens, mask) for f in reward_fns], dim=-1)


def score_batch_banded(helpful, harmful, tokens: torch.Tensor,
                       mask: torch.Tensor, n_objectives: int,
                       length_tolerance: int) -> torch.Tensor:
    """Band-parameterised twin of ``score_batch``: (B, S) -> (B, M)."""
    if n_objectives > 3:
        raise ValueError("at most 3 synthetic objectives")
    cols = [helpfulness_reward(tokens, mask, helpful),
            harmlessness_reward(tokens, mask, harmful),
            conciseness_reward(tokens, mask, length_tolerance)]
    return torch.stack(cols[:n_objectives], dim=-1)


# ---------------------------------------------------------------- learned RM
def init_learned_rm(vocab: int, d: int = 64, *, generator: torch.Generator,
                    device="cuda") -> dict:
    """A tiny fixed (frozen) scoring head: mean embedding -> scalar, with
    an arbitrary preference direction (robustness experiments).  f32
    ``embed`` (vocab, d) ~ N(0, 0.05^2) and ``w`` (d,) ~ N(0, 0.3^2),
    drawn in that order from ``generator`` on ``device``."""
    dev = device_lib.resolve(device)
    embed = torch.randn((vocab, d), generator=generator, device=dev) * 0.05
    w = torch.randn((d,), generator=generator, device=dev) * 0.3
    return {"embed": embed, "w": w}


def learned_rm_score(p: dict, tokens: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens and mask -> (B,) scores in [0, 1]: the sigmoid of the
    masked mean embedding's product with ``w``."""
    e = p["embed"][tokens]                                   # (B, S, d)
    m = mask[..., None]
    pooled = (e * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    return torch.sigmoid(pooled @ p["w"])
