"""The FIRM client-local update step (counterpart of ``repro.rlhf.local``;
Alg. 1, the body of the inner loop).

Pipeline: multi-objective PPO gradients (one forward, M pulls) ->
in-client regularized MGDA resolve (Eq. 1) -> Adam on the adapters -> TD
update of the M linear critics -> adaptive-KL bookkeeping.

The baselines reuse the same parts: FedCMOO splits the step in two
around the server's lambda (``fedcmoo_local_grads``, then
``fedcmoo_local_apply``), and linear scalarisation is the two phases with
fixed weights (``linear_local_step``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import FIRMConfig, ModelConfig
from repro_torch.core import firm, mgda
from repro_torch.rlhf import critic as critic_lib
from repro_torch.rlhf import kl as kl_lib
from repro_torch.rlhf import ppo
from repro_torch.train import optim


class ClientState(NamedTuple):
    trainable: object            # LoRA adapters (None slots elsewhere),
                                 # or every parameter (no adapters)
    critic: dict                 # M linear value heads
    opt: optim.AdamState
    lam: torch.Tensor            # smoothed MGDA weights (M,)
    kl_coef: torch.Tensor
    step: torch.Tensor           # local+global step counter (for eta_t)


def init_client_state(trainable, m: int, d_model: int,
                      kl_coef: float = 0.1, device="cuda") -> ClientState:
    dev = device_lib.resolve(device)
    return ClientState(
        trainable=trainable,
        critic=critic_lib.init_critic(m, d_model, device=dev),
        opt=optim.adam_init(trainable),
        lam=torch.full((m,), 1.0 / m, dtype=torch.float32, device=dev),
        kl_coef=torch.tensor(kl_coef, dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def firm_local_step(cfg: ModelConfig, fc: FIRMConfig, state: ClientState,
                    frozen, batch: ppo.PPOBatch,
                    aux: Optional[dict] = None, gram_fn=None,
                    preference=None, beta=None):
    """One local FIRM update.  Returns (new_state, metrics).

    ``aux`` is the modality stub of a config with cross blocks
    (``{'vision': ...}`` or ``{'frames': ...}``), read by the forward;
    ``gram_fn`` overrides ``resolve``'s Gram matrix (by default the kernel
    on CUDA); ``preference`` is an (M,) tensor overriding
    ``fc.preference``, which is how the round passes each client its own
    preference; ``beta`` a 0-d f32 tensor overriding ``fc.beta``, which
    is how a captured update reads it.
    """
    grads, losses, extras = fedcmoo_local_grads(cfg, fc, state, frozen,
                                                batch, aux)
    eta = firm.eta_schedule(state.step + 1) if fc.lambda_smoothing else None
    res = firm.resolve(grads, fc, prev_lam=state.lam, eta=eta,
                       gram_fn=gram_fn, preference=preference, beta=beta)
    new_state, metrics = _apply(fc, state, res.direction, res.lam, extras)
    return new_state, dict(metrics, losses=losses, lam_star=res.lam_star,
                           gram=res.gram, rewards=batch.rewards.mean(0))


def _apply(fc: FIRMConfig, state: ClientState, direction, lam, extras):
    """The rest of a local step once its direction is known: Adam on the
    adapters, the critics' TD step and the KL controller, with ``lam``
    the client's new lambda.  Returns (new_state, metrics)."""
    metrics, feats, r_tok, mask = extras
    new_trainable, new_opt, gnorm = optim.adam_update(
        direction, state.opt, state.trainable, lr=fc.actor_lr,
        max_grad_norm=1.0)
    r_w = critic_lib.r_w_bound(r_max=1.0)
    new_critic, td_err = critic_lib.td_update(
        state.critic, feats, r_tok, mask, fc.gamma, fc.critic_lr, r_w)
    new_kl = kl_lib.adaptive_kl_update(state.kl_coef, metrics["kl"],
                                       fc.kl_target)
    new_state = ClientState(new_trainable, new_critic, new_opt, lam,
                            new_kl, state.step + 1)
    return new_state, dict(metrics, lam=lam, grad_norm=gnorm, td_err=td_err)


def fedcmoo_local_grads(cfg: ModelConfig, fc: FIRMConfig,
                        state: ClientState, frozen, batch: ppo.PPOBatch,
                        aux: Optional[dict] = None):
    """FedCMOO client phase 1 (and the first part of every local step):
    the M gradients the client sends up.

    Returns (grads, losses, extras); ``extras`` (metrics, features, shaped
    rewards, mask) are what the rest of the step needs, all detached, so
    that a client's extras waiting across the server exchange keep no
    autograd graph alive.
    """
    grads, losses, (metrics, feats, r_tok, _, mask) = \
        ppo.per_objective_grads(cfg, fc, state.trainable, frozen,
                                state.critic, batch, state.kl_coef, aux)
    return grads, losses, (metrics, feats, r_tok, mask)


def fedcmoo_local_apply(fc: FIRMConfig, state: ClientState, grads,
                        lam: torch.Tensor, extras):
    """FedCMOO client phase 2: apply the server's lambda (kept unsmoothed
    as the client's ``lam``).  Returns (new_state, metrics)."""
    return _apply(fc, state, mgda.combine(grads, lam), lam, extras)


def linear_local_step(cfg: ModelConfig, fc: FIRMConfig, state: ClientState,
                      frozen, batch: ppo.PPOBatch, weights: torch.Tensor,
                      aux: Optional[dict] = None):
    """Fixed-weight linear scalarisation step (the implicit RQ1 baseline):
    ``fedcmoo_local_grads`` then ``fedcmoo_local_apply`` with the constant
    lambda ``weights``.  Returns (new_state, metrics)."""
    grads, losses, extras = fedcmoo_local_grads(cfg, fc, state, frozen,
                                                batch, aux)
    new_state, metrics = fedcmoo_local_apply(fc, state, grads, weights,
                                             extras)
    return new_state, dict(metrics, losses=losses,
                           rewards=batch.rewards.mean(0))
