"""Adaptive KL controller (counterpart of ``repro.rlhf.kl``; paper §5:
adaptive KL with target 0.03, TRL-style proportional controller)."""
from __future__ import annotations

import torch


def adaptive_kl_update(kl_coef: torch.Tensor, observed_kl: torch.Tensor,
                       target: float, horizon: float = 64.0) -> torch.Tensor:
    """coef <- clip(coef * (1 + clip(kl / target - 1, +-0.2) * 64 /
    horizon), 1e-4, 10)."""
    err = torch.clamp(observed_kl / max(target, 1e-8) - 1.0, -0.2, 0.2)
    mult = 1.0 + err * (1.0 / horizon) * 64.0
    return torch.clamp(kl_coef * mult, 1e-4, 10.0)
