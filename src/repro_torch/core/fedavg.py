"""FedAvg aggregation over a stacked client axis (counterpart of
``repro.core.fedavg``; ``fedavg_collective`` waits for the multi-card
slice)."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import trees


def stack_trees(tree_list: Sequence):
    """C trees of one structure -> one tree with a leading client axis."""
    return trees.tree_map(lambda *xs: torch.stack(xs), *tree_list)


def unstack_tree(tree, n: int):
    """Inverse of ``stack_trees``: n per-client trees (views)."""
    return [trees.tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


def fedavg_stacked(stacked):
    """theta <- (1/C) sum_c theta_c over the leading client axis."""
    return trees.tree_map(lambda x: x.mean(dim=0), stacked)


def staleness_weights(staleness, pow: float = 0.5) -> torch.Tensor:
    """FedBuff-style discounting w_i proportional to (1 + s_i)^-pow,
    normalised; zero staleness gives exactly 1/C each."""
    s = torch.as_tensor(staleness, dtype=torch.float32)
    # the exponent is filled on the device, not copied from the host
    w = (1.0 + s) ** torch.full((), -pow, dtype=torch.float32,
                                device=s.device)
    return w / w.sum()


def fedavg_flat_weighted(flats: torch.Tensor, weights: torch.Tensor
                         ) -> torch.Tensor:
    """(C, d) stacked flat deltas x (C,) weights -> (d,) aggregate."""
    return torch.as_tensor(weights, dtype=torch.float32,
                           device=flats.device) @ flats
