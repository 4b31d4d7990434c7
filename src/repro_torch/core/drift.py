"""Multi-objective disagreement drift diagnostics (counterpart of
``repro.core.drift``): ``lambda_disagreement``, ``param_drift`` and
``param_drift_stacked`` of the round summary, and the empirical check of
the paper's Lemma F.6 (``gradient_bound_R``, ``lemma_f6_check``)."""
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


def _tree_norm(tree) -> torch.Tensor:
    """The L2 norm of a tree's leaves taken together."""
    return torch.sqrt(sum(torch.sum(t * t) for t in trees.tree_leaves(tree)))


def gradient_bound_R(grads: Sequence) -> torch.Tensor:
    """R = max_j ||g_j||_2 over the objectives' gradient trees (the
    empirical stand-in of Lemma F.5's bound)."""
    return torch.max(torch.stack([_tree_norm(g) for g in grads]))


def lemma_f6_check(grads_c: Sequence, grads_c2: Sequence,
                   lam_c: torch.Tensor, lam_c2: torch.Tensor,
                   beta: float) -> dict:
    """Empirical check of Lemma F.6,
    ||lambda*_c - lambda*_c'|| <= (4 R M / beta) max_j ||g_j^c - g_j^c'||,
    for two clients' M gradient trees and MGDA weights: ``lhs``, ``rhs``,
    ``R`` and ``max_grad_diff``, as the reference's (raw gradients; the
    trace normalisation of App. A is not applied)."""
    m = len(grads_c)
    r = torch.maximum(gradient_bound_R(grads_c), gradient_bound_R(grads_c2))
    max_diff = torch.max(torch.stack([
        _tree_norm(trees.tree_map(lambda a, b: a - b, gc, gc2))
        for gc, gc2 in zip(grads_c, grads_c2)]))
    lhs = torch.linalg.vector_norm(lam_c - lam_c2)
    rhs = (4.0 * r * m / beta) * max_diff
    return {"lhs": lhs, "rhs": rhs, "R": r, "max_grad_diff": max_diff}


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
