"""Regularized MGDA subproblem solvers (counterpart of ``repro.core.mgda``;
paper Eq. 1-3, 9, App. A/H).

Solve  lambda* = argmin_{lambda in simplex_M} lambda^T (G^ + R) lambda,
with G^ the (optionally trace-normalised, App. A) Gram matrix of the M
objective gradients and R the uniform regulariser (beta/2) I (Eq. 2) or
the preference regulariser Diag(p^-1) (Eq. 3 / App. H).  The solvers run
a fixed number of iterations, as the reference's do:

  - closed_form_m2 : exact for M = 2
  - pgd            : projected gradient descent, sort-based projection
  - frank_wolfe    : Frank-Wolfe with exact line search
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.trees import tree_leaves, tree_map


def gram_matrix(grads) -> torch.Tensor:
    """G_ij = <g_i, g_j> (f32) of M gradient trees, or of a stacked (M, d)
    tensor; the plain pairwise form, leaf by leaf."""
    if isinstance(grads, torch.Tensor):
        xf = grads.float()
        return xf @ xf.T
    leaves = [tree_leaves(g) for g in grads]

    def dot(i, j):
        return sum(torch.vdot(a.float().reshape(-1), b.float().reshape(-1))
                   for a, b in zip(leaves[i], leaves[j]))

    m = len(grads)
    return torch.stack([torch.stack([dot(i, j) for j in range(m)])
                        for i in range(m)])


def regularize(G: torch.Tensor, beta: float,
               preference: Optional[torch.Tensor] = None,
               trace_normalize: bool = True) -> torch.Tensor:
    """G^ + (beta/2) I  or  G^ + Diag(p^-1)  (Eq. 9 / Eq. 3)."""
    m = G.shape[0]
    if trace_normalize:
        G = G / torch.clamp(torch.trace(G) / m, min=1e-12)      # App. A
    if preference is not None:
        p = torch.as_tensor(preference, dtype=torch.float32, device=G.device)
        return G + torch.diag(1.0 / torch.clamp(p, min=1e-9))
    return G + 0.5 * beta * torch.eye(m, dtype=G.dtype, device=G.device)


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of a vector onto the probability simplex."""
    m = v.shape[-1]
    u = torch.sort(v, descending=True).values
    css = torch.cumsum(u, dim=-1)
    k = torch.arange(1, m + 1, dtype=v.dtype, device=v.device)
    rho = torch.sum(u + (1.0 - css) / k > 0, dim=-1)
    theta = (css[rho - 1] - 1.0) / rho.to(v.dtype)
    return torch.clamp(v - theta, min=0.0)


def solve_qp_pgd(Q: torch.Tensor, iters: int = 100,
                 lam0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """min over the simplex of lambda^T Q lambda by projected gradient."""
    m = Q.shape[0]
    lam = lam0 if lam0 is not None else torch.full(
        (m,), 1.0 / m, dtype=torch.float32, device=Q.device)
    step = 1.0 / (2.0 * torch.linalg.matrix_norm(Q, ord="fro") + 1e-9)
    for _ in range(iters):
        lam = project_simplex(lam - step * (2.0 * Q @ lam))
    return lam


def solve_qp_m2(Q: torch.Tensor) -> torch.Tensor:
    """Exact minimiser on the 2-simplex: lambda = [t, 1 - t]."""
    a = Q[0, 0] - 2.0 * Q[0, 1] + Q[1, 1]
    t = torch.where(a > 1e-12, (Q[1, 1] - Q[0, 1]) / torch.clamp(a, min=1e-12),
                    torch.full_like(a, 0.5))
    t = torch.clamp(t, 0.0, 1.0)
    return torch.stack([t, 1.0 - t])


def solve_qp_frank_wolfe(Q: torch.Tensor, iters: int = 100) -> torch.Tensor:
    m = Q.shape[0]
    lam = torch.full((m,), 1.0 / m, dtype=torch.float32, device=Q.device)
    eye = torch.eye(m, dtype=torch.float32, device=Q.device)
    for _ in range(iters):
        d = eye[torch.argmin(2.0 * Q @ lam)] - lam
        # exact line search for the quadratic: gamma* = -lam^T Q d / d^T Q d
        denom = d @ Q @ d
        gamma = torch.where(
            denom > 1e-12,
            torch.clamp(-(lam @ Q @ d) / torch.clamp(denom, min=1e-12),
                        0.0, 1.0),
            torch.zeros_like(denom))
        lam = lam + gamma * d
    return lam


def solve(G: torch.Tensor, beta: float,
          preference: Optional[torch.Tensor] = None,
          trace_normalize: bool = True, solver: str = "pgd",
          iters: int = 100) -> torch.Tensor:
    """Regularise G and return lambda* in the simplex."""
    Q = regularize(G, beta, preference, trace_normalize)
    if solver == "closed_form_m2":
        if G.shape[0] != 2:
            raise ValueError("closed_form_m2 requires M=2")
        return solve_qp_m2(Q)
    if solver == "frank_wolfe":
        return solve_qp_frank_wolfe(Q, iters)
    return solve_qp_pgd(Q, iters)


def combine(grads, lam: torch.Tensor):
    """g = sum_j lambda_j g_j over trees (or a stacked (M, d) tensor)."""
    if isinstance(grads, torch.Tensor):
        return torch.einsum("m,md->d", lam, grads)
    out = tree_map(lambda x: lam[0].to(x.dtype) * x, grads[0])
    for j in range(1, len(grads)):
        out = tree_map(lambda a, x, j=j: a + lam[j].to(x.dtype) * x, out,
                       grads[j])
    return out
