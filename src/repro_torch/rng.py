"""Categorical sampling as JAX does it: argmax of logits plus Gumbel noise.

``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel)``.
The port draws the Gumbel noise from an explicit ``torch.Generator``, or
takes it injected, so that a test can feed both sides the same draws.
"""
from __future__ import annotations

import torch


def gumbel_noise(shape, *, generator: torch.Generator, device
                 ) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def categorical(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Index of the max of ``logits + noise`` on the last axis (int64)."""
    return torch.argmax(logits + noise.to(logits.device), dim=-1)
