"""TFIRM critics: M linear value functions on a shared feature map
(counterpart of ``repro.rlhf.critic``; paper Assumption 4.2 / Algorithm 3).

phi(s) = the normalised last hidden state, detached, with ||phi|| <= 1.
Each objective j has w_j in R^d, trained by mini-batch TD with a
projection onto the ball of radius R_w.
"""
from __future__ import annotations

import torch

from repro_torch import device as device_lib


def init_critic(m: int, d: int, device="cuda"):
    return {"w": torch.zeros((m, d), dtype=torch.float32,
                             device=device_lib.resolve(device))}


def features(hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, d) hidden -> normalised features with ||phi|| <= 1."""
    h = hidden.detach().float()
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                           min=1.0)


def values(critic, feats: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, M)."""
    return torch.einsum("bsd,md->bsm", feats, critic["w"])


def project(critic, r_w: float):
    """Scale each w_j back into the R_w ball (Alg. 3, closed form)."""
    n = torch.linalg.vector_norm(critic["w"], dim=-1, keepdim=True)
    scale = torch.clamp(r_w / torch.clamp(n, min=1e-12), max=1.0)
    return {"w": critic["w"] * scale}


def td_update(critic, feats: torch.Tensor, rewards_tok: torch.Tensor,
              mask: torch.Tensor, gamma: float, lr: float, r_w: float):
    """One mini-batch TD step for all M critics (Alg. 3 line 11).

    feats: (B, S, d); rewards_tok: (B, S, M); mask: (B, S).
    delta_t = r_t + gamma phi(s_{t+1})^T w - phi(s_t)^T w.
    Returns (new critic, mean |delta|).
    """
    v = values(critic, feats)                                # (B, S, M)
    v_next = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)
    next_mask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])],
                          dim=1)
    delta = rewards_tok + gamma * v_next * next_mask[..., None] - v
    delta = delta * mask[..., None]
    n = torch.clamp(mask.sum(), min=1.0)
    grad = torch.einsum("bsm,bsd->md", delta, feats) / n
    new = {"w": critic["w"] + lr * grad}                     # TD ascent
    return project(new, r_w), torch.mean(torch.abs(delta))


def r_w_bound(r_max: float, lambda_a: float = 0.1) -> float:
    """R_w = 2 r_max / lambda_A (App. C)."""
    return 2.0 * r_max / lambda_a
