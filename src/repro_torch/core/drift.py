"""Disagreement drift diagnostics of the round summary (counterpart of
``repro.core.drift``: ``lambda_disagreement``, ``param_drift`` and
``param_drift_stacked``; the Lemma F.6 checks are not ported yet)."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import trees


def lambda_disagreement(lams: torch.Tensor) -> dict:
    """lams: (C, M) per-client MGDA weights -> mean and max pairwise
    ||lambda_c - lambda_c'|| and the mean distance to the mean lambda."""
    c = lams.shape[0]
    diff = lams[:, None, :] - lams[None, :, :]                # (C, C, M)
    pd = torch.sqrt(torch.sum(diff ** 2, -1) + 1e-30)
    iu = torch.triu_indices(c, c, offset=1, device=lams.device)
    off = pd[iu[0], iu[1]]
    zero = torch.zeros((), dtype=lams.dtype, device=lams.device)
    return {
        "pairwise_mean": off.mean() if off.numel() else zero,
        "pairwise_max": off.max() if off.numel() else zero,
        "to_mean": torch.sqrt(((lams - lams.mean(0)) ** 2).sum(-1)).mean(),
    }


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.float().reshape(-1) for t in trees.tree_leaves(tree)])


def param_drift(client_trees: Sequence) -> torch.Tensor:
    """Mean pairwise L2 distance between client parameter trees."""
    flats = [_flat(t) for t in client_trees]
    total, n = torch.zeros((), device=flats[0].device), 0
    for i in range(len(flats)):
        for j in range(i + 1, len(flats)):
            total = total + torch.linalg.vector_norm(flats[i] - flats[j])
            n += 1
    return total / max(n, 1)


def param_drift_stacked(stacked_tree) -> torch.Tensor:
    """``param_drift`` over a tree with a leading client axis.

    Subtract first, one client's row at a time, as the reference does:
    O(C d) memory, and none of the cancellation of a Gram-matrix form when
    clients have moved only slightly apart.
    """
    leaves = trees.tree_leaves(stacked_tree)
    c = leaves[0].shape[0]
    if c < 2:
        return torch.zeros((), device=leaves[0].device)
    flat = torch.cat([t.float().reshape(c, -1) for t in leaves], dim=1)
    total = torch.zeros((), dtype=torch.float32, device=flat.device)
    for i in range(c):
        total = total + torch.sqrt(((flat - flat[i]) ** 2).sum(-1)).sum()
    return total / 2.0 / (c * (c - 1) // 2)
