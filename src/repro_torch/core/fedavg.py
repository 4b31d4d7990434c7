"""FedAvg aggregation (counterpart of ``repro.core.fedavg``): over a list
of client trees (``fedavg``, ``fedavg_weighted``), over a stacked client
axis (``fedavg_stacked``, ``fedavg_flat_weighted``), and across ranks
(``fedavg_collective``: one all-reduce a leaf over a process group, the
reference's ``pmean`` over the 'pod' axis).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch import trees


def fedavg(tree_list: Sequence):
    """theta <- (1/C) sum_c theta_c over a list of client trees (summed
    in list order, then divided)."""
    out = tree_list[0]
    for t in tree_list[1:]:
        out = trees.tree_map(lambda a, b: a + b, out, t)
    return trees.tree_map(lambda a: a / len(tree_list), out)


def fedavg_weighted(tree_list: Sequence, weights: Sequence[float]):
    """sum_c w_c theta_c with the weights normalised to sum to 1 (f32)."""
    leaf = trees.tree_leaves(tree_list[0])[0]
    w = torch.as_tensor(weights, dtype=torch.float32, device=leaf.device)
    w = w / w.sum()
    out = trees.tree_map(lambda a: a * w[0], tree_list[0])
    for i, t in enumerate(tree_list[1:], start=1):
        out = trees.tree_map(lambda a, b: a + b * w[i], out, t)
    return out


def fedavg_collective(tree, group=None, *, mesh=None, dim: str = "pod",
                      count: Optional[int] = None):
    """The mean of ``tree`` over the ranks of a process group: one
    all-reduce (sum) of each leaf, then a division by ``count``.

    The group is ``group`` (the default group when neither it nor
    ``mesh`` is given) or ``mesh``'s group over its dim ``dim`` (a
    ``DeviceMesh``).  ``count`` is the number of clients the sum holds,
    the group's size unless a rank's tree is already the sum of several.
    Plain tensors only; ``launch.steps`` hands a DTensor's shard.  This
    is the only cross-pod communication a FIRM round emits.
    """
    if group is None:
        group = mesh.get_group(dim) if mesh is not None else dist.group.WORLD
    n = dist.get_world_size(group) if count is None else count
    return trees.tree_map(
        lambda x: funcol.all_reduce(x, "sum", group) / n, tree)


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
