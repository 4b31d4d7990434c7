"""Autoregressive response generation with the decode cache.

Counterpart of ``repro.rlhf.sampling.generate``.  Sampling is the argmax of
the tempered logits plus Gumbel noise, which is what
``jax.random.categorical`` computes.  The noise comes from ``generator``,
or is injected whole as ``gumbel`` (``(max_new, B, V)``), so that a test
can hand the port JAX's own draws.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.rng import categorical, gumbel_noise


@torch.no_grad()
def generate(cfg: ModelConfig, params, prompt: torch.Tensor, *,
             max_new: int = 32, temperature: float = 1.0,
             generator: Optional[torch.Generator] = None,
             gumbel: Optional[torch.Tensor] = None):
    """prompt: (B, P) -> (tokens (B, P+max_new), logprobs, mask).

    logprobs are the sampling logprobs at generated positions, 0 elsewhere;
    mask is 1.0 on generated positions.  Tokens are int64.

    As in the reference, the prefill logits are not used: the last prompt
    token is fed again as the first decode input, at position P, so it
    sits twice in the cache (and a Mamba2 layer's state advances twice
    with it).
    """
    if (generator is None) == (gumbel is None):
        raise ValueError("pass exactly one of generator= and gumbel=")
    prompt = prompt.long()
    b, p = prompt.shape
    _, cache = transformer.prefill(cfg, params, prompt,
                                   cache_len=p + max_new)
    tok = prompt[:, -1:]
    new_toks, new_lps = [], []
    for i in range(max_new):
        logits, cache = transformer.decode_step(cfg, params, cache, tok)
        logits = logits.float() / max(temperature, 1e-6)
        noise = (gumbel[i] if gumbel is not None else
                 gumbel_noise(logits.shape, generator=generator,
                              device=logits.device))
        nxt = categorical(logits, noise)
        lp = torch.log_softmax(logits, dim=-1).gather(-1, nxt[:, None])[:, 0]
        new_toks.append(nxt)
        new_lps.append(lp)
        tok = nxt[:, None]
    zeros = torch.zeros((b, p), dtype=torch.float32, device=prompt.device)
    tokens = torch.cat([prompt, torch.stack(new_toks, dim=1)], dim=1)
    logprobs = torch.cat([zeros, torch.stack(new_lps, dim=1)], dim=1)
    mask = torch.cat([zeros, torch.ones((b, max_new), dtype=torch.float32,
                                        device=prompt.device)], dim=1)
    return tokens, logprobs, mask
