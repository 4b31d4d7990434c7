"""Categorical sampling as JAX does it: argmax of logits plus Gumbel noise.

``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel)``.
The port draws the Gumbel noise from an explicit ``torch.Generator``, or
takes it injected, so that a test can feed both sides the same draws.
The noise is a uniform draw and a transform of it: ``uniform_noise`` can
draw into a static buffer (``out=``), as the captured decode step of
``rlhf.sampling`` needs, drawn outside the graph before each replay, and
``gumbel_from_uniform`` is the transform the graph holds.  Together they
give the bits of ``gumbel_noise`` for the same generator and order of
draws.
"""
from __future__ import annotations

from typing import Optional

import torch


def uniform_noise(shape, *, generator: torch.Generator, device,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 uniform in [0, 1) of ``shape``; with ``out`` (f32, of
    ``shape``) drawn into it in place and returned."""
    if out is None:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
    if out.dtype != torch.float32 or tuple(out.shape) != tuple(shape):
        raise ValueError(f"out must be float32 of shape {tuple(shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out.uniform_(generator=generator)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u clamped to [tiny, 1)."""
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_noise(shape, *, generator: torch.Generator, device
                 ) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1)."""
    return gumbel_from_uniform(uniform_noise(shape, generator=generator,
                                             device=device))


def categorical(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Index of the max of ``logits + noise`` on the last axis (int64)."""
    return torch.argmax(logits + noise.to(logits.device), dim=-1)
