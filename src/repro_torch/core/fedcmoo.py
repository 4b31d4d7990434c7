"""FedCMOO baseline: server-centric conflict resolution (counterpart of
``repro.core.fedcmoo``; Askin et al. 2024, adapted to alignment as in the
paper's RQ1).

Protocol per local step: every client sends its M objective gradients
(optionally sketched) to the server; the server averages them, solves ONE
MGDA problem and broadcasts the global lambda back; the clients then apply
g_c = sum_j lambda_j g_j^c.  Communication is O(CMd) uncompressed, O(CMq)
with a rank-q sketch, plus the lambda round trip every step.

The server's Gram matrix goes through ``kernels.ops.gram``: the Hopper
kernel for a CUDA tensor, the plain version for a CPU one.  The sketch's
(d, q) standard normal draw comes from a generator on the device, or is
injected as ``noise`` so that a test can hand the port JAX's draw.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch import trees
from repro_torch.core import mgda
from repro_torch.kernels import ops


def flatten_grads(grads: Sequence) -> torch.Tensor:
    """List of M gradient trees -> (M, d) f32, leaves in sorted-key
    order."""
    return torch.stack([torch.cat([leaf.float().reshape(-1)
                                   for leaf in trees.tree_leaves(g)])
                        for g in grads])


def stack_grads_flat(grads: Sequence, m: int) -> torch.Tensor:
    """M gradient trees, each with a leading (C,) client axis -> (C, M, d)
    f32.  Row (c, j) is bit for bit ``flatten_grads`` of client c's j-th
    tree: the batched form of the server exchange's per-client flatten."""
    mats = [torch.cat([leaf.float().reshape(leaf.shape[0], -1)
                       for leaf in trees.tree_leaves(grads[j])], dim=1)
            for j in range(m)]
    return torch.stack(mats, dim=1)


def sketch_noise(d: int, q: int, generator: torch.Generator) -> torch.Tensor:
    """The sketch's (d, q) standard normal draw, on the generator's
    device."""
    return torch.randn((d, q), generator=generator, dtype=torch.float32,
                       device=generator.device)


def sketch(flat: torch.Tensor, q: int,
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JL sketch (M, d) -> (M, q): ``flat @ (noise / sqrt(q))``, which
    keeps the Gram matrix approximately.  ``noise`` is the (d, q) normal
    draw; without it one is drawn from ``generator``."""
    if noise is None:
        noise = sketch_noise(flat.shape[1], q, generator)
    s = noise.to(flat.device, torch.float32) / math.sqrt(q)
    return flat @ s


def server_solve(client_grads: Sequence[torch.Tensor], beta: float = 0.0,
                 trace_normalize: bool = True, solver: str = "pgd",
                 iters: int = 100) -> torch.Tensor:
    """The server step: average the clients' (M, d|q) matrices, solve one
    MGDA problem, return the global lambda.

    The average keeps the reference's association (``sum(list) / C``,
    starting from 0).  beta defaults to 0: FedCMOO does not regularise; it
    avoids disagreement drift by design (one server lambda) at the cost of
    O(CMd) communication.
    """
    avg = sum(client_grads) / len(client_grads)
    G = ops.gram(avg.contiguous())
    return mgda.solve(G, beta, trace_normalize=trace_normalize,
                      solver=solver, iters=iters)


def _sketched(mats, compress_rank, generator, noise):
    """Every client's matrix sketched with ONE draw (the reference's first
    client key), so that the clients' sketches share a basis."""
    if not compress_rank:
        return mats
    if noise is None:
        noise = sketch_noise(mats[0].shape[1], compress_rank, generator)
    return [sketch(m, compress_rank, noise=noise) for m in mats]


def fedcmoo_round_lambda(per_client_grads: Sequence[Sequence],
                         compress_rank: Optional[int] = None,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None,
                         **solve_kw) -> torch.Tensor:
    """One conflict-resolution round; ``per_client_grads[c]`` is client
    c's M gradient trees.  With ``compress_rank`` the gradients are
    sketched to that rank first, with ``noise`` or a draw from
    ``generator``."""
    mats = [flatten_grads(g) for g in per_client_grads]
    return server_solve(_sketched(mats, compress_rank, generator, noise),
                        **solve_kw)


def fedcmoo_round_lambda_stacked(stacked: torch.Tensor,
                                 compress_rank: Optional[int] = None,
                                 generator: Optional[torch.Generator] = None,
                                 noise: Optional[torch.Tensor] = None,
                                 **solve_kw) -> torch.Tensor:
    """``fedcmoo_round_lambda`` on the (C, M, d) stack of the clients'
    matrices as the server decodes them; the same lambda."""
    mats = [stacked[c] for c in range(stacked.shape[0])]
    return server_solve(_sketched(mats, compress_rank, generator, noise),
                        **solve_kw)
