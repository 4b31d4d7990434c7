"""The FIRM client-local update step (counterpart of ``repro.rlhf.local``;
Alg. 1, the body of the inner loop).

Pipeline: multi-objective PPO gradients (one forward, M pulls) ->
in-client regularized MGDA resolve (Eq. 1) -> Adam on the adapters -> TD
update of the M linear critics -> adaptive-KL bookkeeping.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import FIRMConfig, ModelConfig
from repro_torch.core import firm
from repro_torch.rlhf import critic as critic_lib
from repro_torch.rlhf import kl as kl_lib
from repro_torch.rlhf import ppo
from repro_torch.train import optim


class ClientState(NamedTuple):
    trainable: object            # LoRA adapters (None slots elsewhere)
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
                    frozen, batch: ppo.PPOBatch):
    """One local FIRM update.  Returns (new_state, metrics).

    The Gram matrix is ``resolve``'s default (the kernel on CUDA); the
    reference's ``gram_fn`` and traced ``preference`` overrides come with
    the vectorized round that passes them.
    """
    grads, losses, (metrics, feats, r_tok, _, mask) = \
        ppo.per_objective_grads(cfg, fc, state.trainable, frozen,
                                state.critic, batch, state.kl_coef)
    eta = firm.eta_schedule(state.step + 1) if fc.lambda_smoothing else None
    res = firm.resolve(grads, fc, prev_lam=state.lam, eta=eta)
    new_trainable, new_opt, gnorm = optim.adam_update(
        res.direction, state.opt, state.trainable, lr=fc.actor_lr,
        max_grad_norm=1.0)
    r_w = critic_lib.r_w_bound(r_max=1.0)
    new_critic, td_err = critic_lib.td_update(
        state.critic, feats, r_tok, mask, fc.gamma, fc.critic_lr, r_w)
    new_kl = kl_lib.adaptive_kl_update(state.kl_coef, metrics["kl"],
                                       fc.kl_target)
    new_state = ClientState(new_trainable, new_critic, new_opt, res.lam,
                            new_kl, state.step + 1)
    metrics = dict(metrics, losses=losses, lam=res.lam,
                   lam_star=res.lam_star, gram=res.gram, grad_norm=gnorm,
                   td_err=td_err, rewards=batch.rewards.mean(0))
    return new_state, metrics
