"""Non-IID client partitioning: Dirichlet(alpha) over topics (paper §5 RQ1
uses Dir(0.3)).  Counterpart of ``repro.data.partition``.

``torch.distributions.Dirichlet`` takes no generator, so the Gamma draws
behind it are made here, by Marsaglia and Tsang's method, from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.data.prompts import N_TOPICS, PromptDataset


def _gamma(alpha: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws, one per entry of ``alpha``.

    Marsaglia & Tsang (2000): for a >= 1, x ~ N(0, 1), v = (1 + c x)^3 with
    d = a - 1/3, c = 1/sqrt(9d); accept d v when
    log u < x^2/2 + d - d v + d log v.  For a < 1 draw with a + 1 and
    multiply by u^(1/a).
    """
    dev = alpha.device
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(alpha)
    todo = torch.ones_like(alpha, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(alpha.shape, generator=generator, device=dev)
        u = torch.rand(alpha.shape, generator=generator, device=dev)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-30)))
        take = todo & ok
        out[take] = (d * v)[take]
        todo &= ~ok
    u = torch.rand(alpha.shape, generator=generator, device=dev)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def dirichlet_topic_mixtures(n_clients: int, alpha: float = 0.3,
                             n_topics: int = N_TOPICS, *,
                             generator: torch.Generator,
                             device="cuda") -> torch.Tensor:
    """(C, n_topics) per-client topic mixtures; alpha->inf is IID."""
    dev = device_lib.resolve(device)
    conc = torch.full((n_clients, n_topics), float(alpha), device=dev)
    g = _gamma(conc, generator)
    return g / g.sum(-1, keepdim=True)


def heterogeneity_stat(mixtures: torch.Tensor) -> torch.Tensor:
    """Mean total-variation distance of the clients' mixtures (C, T) from
    the global mixture: an empirical proxy for the paper's zeta
    (Assumption 4.4)."""
    g = mixtures.mean(0)
    return 0.5 * torch.abs(mixtures - g).sum(-1).mean()


def make_client_datasets(n_clients: int, vocab: int, prompt_len: int,
                         alpha: float = 0.3, *, generator: torch.Generator,
                         device="cuda"):
    """One ``PromptDataset`` per client, all drawing from ``generator``."""
    mix = dirichlet_topic_mixtures(n_clients, alpha, generator=generator,
                                   device=device)
    return [PromptDataset(vocab, prompt_len, mix[c], generator=generator,
                          device=device) for c in range(n_clients)]


def sample_prompt_block(datasets, batch_size: int) -> torch.Tensor:
    """One batch from each client's own prompt stream -> (C, B, P), the
    counterpart of the reference's vmapped ``sample_prompt_block``."""
    return torch.stack([ds.next_batch(batch_size) for ds in datasets])
