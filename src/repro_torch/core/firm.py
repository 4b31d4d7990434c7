"""FIRM in-client gradient resolution (counterpart of ``repro.core.firm``;
paper Alg. 1 / Alg. 2 Eq. 12).

``resolve`` forms the Gram matrix of the M per-objective gradients (by
default ``kernels.ops.gram_from_pytrees``: the Hopper kernel for CUDA
tensors, the plain version for CPU ones), solves the beta-regularised MGDA
QP, optionally smooths lambda with the eta_t schedule, and returns the
consensus direction g = sum_j lambda_j g_j.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.configs.base import FIRMConfig
from repro_torch.core import mgda
from repro_torch.kernels import ops


class ResolveResult(NamedTuple):
    direction: object            # tree: sum_j lambda_j g_j
    lam: torch.Tensor            # lambda used for the update (smoothed)
    lam_star: torch.Tensor       # raw QP solution lambda*
    gram: torch.Tensor           # unnormalised Gram matrix (M, M)


def resolve(grads: Sequence, fc: FIRMConfig,
            prev_lam: Optional[torch.Tensor] = None,
            eta: Optional[torch.Tensor] = None,
            gram_fn=None,
            preference: Optional[torch.Tensor] = None) -> ResolveResult:
    """Resolve M per-objective gradients into one direction (Eq. 1).

    grads: list of M gradient trees.  prev_lam/eta: the lambda smoothing
    state (Alg. 2 Eq. 12).  gram_fn: override of the Gram computation
    (e.g. ``mgda.gram_matrix``).  preference: (M,) overriding
    ``fc.preference``.
    """
    G = (gram_fn or ops.gram_from_pytrees)(grads)
    if preference is not None:
        pref = torch.as_tensor(preference, dtype=torch.float32,
                               device=G.device)
    elif fc.preference is not None:
        pref = torch.tensor(fc.preference, dtype=torch.float32,
                            device=G.device)
    else:
        pref = None
    lam_star = mgda.solve(G, fc.beta, preference=pref,
                          trace_normalize=fc.trace_normalize,
                          solver=fc.solver, iters=fc.solver_iters)
    if fc.lambda_smoothing and prev_lam is not None:
        e = eta if eta is not None else torch.tensor(
            fc.eta0, dtype=torch.float32, device=G.device)
        lam = (1.0 - e) * prev_lam + e * lam_star
    else:
        lam = lam_star
    direction = mgda.combine(grads, lam)
    return ResolveResult(direction, lam, lam_star, G)


def eta_schedule(t: torch.Tensor) -> torch.Tensor:
    """eta_t = 1/t (App. F.3.3), with eta_1 = 1."""
    return 1.0 / torch.clamp(t.float(), min=1.0)


def staleness_beta(beta: float, staleness, gain: float = 0.5,
                   cap: float = 8.0) -> float:
    """beta_eff = beta * min(1 + gain * s, cap): staleness-aware
    regularization for buffered-async aggregation."""
    return float(beta) * min(1.0 + gain * float(staleness), cap)
