"""Synthetic HH-style prompt distribution (counterpart of ``repro.data.prompts``).

Prompts are token sequences drawn from per-topic unigram distributions
over disjoint-ish vocabulary bands.  Every draw comes from an explicit
``torch.Generator``, or is injected (``noise`` / ``gumbel``) so that a test
can hand the port JAX's draws: the port cannot reproduce threefry's
numbers.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.rng import categorical, gumbel_noise

N_TOPICS = 8


def topic_logits(vocab: int, n_topics: int = N_TOPICS, *,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 device="cuda") -> torch.Tensor:
    """(n_topics, vocab) unigram logits, each topic peaked on its band.

    ``noise`` is the (n_topics, vocab) standard-normal draw; without it,
    one is drawn from ``generator``.
    """
    dev = device_lib.resolve(device)
    if noise is None:
        noise = torch.randn((n_topics, vocab), generator=generator,
                            device=dev)
    base = noise.to(dev, torch.float32) * 0.3
    band = vocab // n_topics
    for t in range(n_topics):
        base[t, t * band:(t + 1) * band] += 2.0
    return base


def sample_prompts(logits: torch.Tensor, topics: torch.Tensor,
                   prompt_len: int, *,
                   generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """topics: (B,) topic id per row -> (B, prompt_len) int64 tokens.

    ``logits`` is the ``topic_logits`` table; ``gumbel`` is the injected
    (prompt_len, B, vocab) noise, one slice per column.
    """
    rows = logits[topics.to(logits.device).long()]               # (B, V)
    cols = []
    for j in range(prompt_len):
        g = (gumbel[j] if gumbel is not None else
             gumbel_noise(rows.shape, generator=generator,
                          device=rows.device))
        cols.append(categorical(rows, g))
    return torch.stack(cols, dim=1)


class PromptDataset:
    """Per-client prompt stream with a fixed topic mixture.

    ``count`` is the number of batches drawn so far, the reference's
    ``_count`` (the engine advances it for injected prompts too).
    """

    def __init__(self, vocab: int, prompt_len: int, topic_probs, *,
                 generator: torch.Generator, device="cuda"):
        self.device = device_lib.resolve(device)
        self.prompt_len = prompt_len
        self.generator = generator
        self.topic_probs = torch.as_tensor(topic_probs, dtype=torch.float32,
                                           device=self.device)
        self.logits = topic_logits(vocab, generator=generator,
                                   device=self.device)
        self.count = 0

    def next_batch(self, batch_size: int) -> torch.Tensor:
        self.count += 1
        topic_logp = torch.log(self.topic_probs + 1e-9)[None].expand(
            batch_size, -1)
        topics = categorical(topic_logp, gumbel_noise(
            topic_logp.shape, generator=self.generator, device=self.device))
        return sample_prompts(self.logits, topics, self.prompt_len,
                              generator=self.generator)
