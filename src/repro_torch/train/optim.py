"""Adam with global-norm clipping over parameter trees, plain SGD and a
cosine learning-rate schedule (counterpart of ``repro.train.optim``).

The state mirrors the parameters: ``mu`` and ``nu`` are f32 trees of the
same structure (None slots included) and ``count`` an int32 scalar.  The
update is pure, as in the reference: it returns new tensors and leaves
its inputs alone.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.trees import tree_leaves, tree_map


class AdamState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor


def adam_init(params) -> AdamState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamState(
        tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params),
        tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params),
        torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), n


def adam_update(grads, state: AdamState, params, *, lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0,
                max_grad_norm: Optional[float] = None):
    """Returns (new_params, new_state, grad_norm)."""
    gn = global_norm(grads)
    if max_grad_norm is not None:
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
    count = state.count + 1
    cf = count.float()
    b1c = 1.0 - b1 ** cf
    b2c = 1.0 - b2 ** cf

    def upd(g, m, v, p):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        step = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        return m, v, (p.float() - lr * step).to(p.dtype)

    flat = tree_map(upd, grads, state.mu, state.nu, params)
    mu = tree_map(lambda t: t[0], flat)
    nu = tree_map(lambda t: t[1], flat)
    new_params = tree_map(lambda t: t[2], flat)
    return new_params, AdamState(mu, nu, count), gn


def sgd_update(grads, params, *, lr):
    """theta <- theta - lr g (the update TFIRM analyses), in f32, cast
    back to each parameter's dtype."""
    return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                    params, grads)


def cosine_lr(base_lr: float, warmup: int, total: int):
    """A function of a step tensor: linear warm-up over ``warmup`` steps,
    then a cosine decay to 0 at ``total``, in f32."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return fn
