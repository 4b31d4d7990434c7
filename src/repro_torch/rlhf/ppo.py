"""Multi-objective PPO: M per-objective clipped-PPO gradients from ONE
shared forward pass (counterpart of ``repro.rlhf.ppo``; paper Alg. 1 lines
6-9).

The M losses share every forward intermediate, so one forward records the
graph and M backward pulls, one per loss, reuse it (the reference pulls M
one-hot cotangents through one ``jax.vjp``).  Advantages follow TFIRM's
TD/GAE construction: per-token shaped rewards are -kl_coef * KL(pi||ref)
at every response token plus the terminal reward-model score r_j at the
final response position.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import FIRMConfig, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import merge_trainable
from repro_torch.rlhf import critic as critic_lib
from repro_torch.trees import tree_leaves, tree_map


class PPOBatch(NamedTuple):
    tokens: torch.Tensor          # (B, S) int64 prompt+response
    response_mask: torch.Tensor   # (B, S) f32: 1 on response positions
    old_logprobs: torch.Tensor    # (B, S) f32 behaviour-policy logprobs
    ref_logprobs: torch.Tensor    # (B, S) f32 frozen reference logprobs
    rewards: torch.Tensor         # (B, M) f32 sequence-level RM scores


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """logprob of tokens[t] under logits[t-1]; position 0 gets 0.

    Returns (B, S) f32 aligned with ``tokens``/masks.
    """
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    lp_tok = lp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return torch.nn.functional.pad(lp_tok, (1, 0))


def shaped_rewards(kl: torch.Tensor, mask: torch.Tensor,
                   rewards: torch.Tensor, kl_coef: torch.Tensor
                   ) -> torch.Tensor:
    """(B,S) kl, (B,S) mask, (B,M) terminal -> (B,S,M) per-token rewards."""
    s = mask.shape[1]
    pos = torch.arange(s, device=mask.device, dtype=mask.dtype)
    last_idx = torch.argmax(mask * pos[None], dim=-1)        # last response
    last = torch.nn.functional.one_hot(last_idx, s).to(torch.float32)
    r = -kl_coef * kl[..., None] * mask[..., None]
    return r + last[..., None] * rewards[:, None, :]


def gae(rewards_tok: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
        gamma: float, lam: float):
    """(B,S,M) rewards, (B,S,M) values -> (advantages, returns).

    The reverse scan of the reference, as a loop over S.
    """
    next_mask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])],
                          dim=1)[..., None]
    v_next = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])],
                       dim=1)
    delta = rewards_tok + gamma * v_next * next_mask - values
    adv = torch.zeros_like(delta[:, 0])
    advs = []
    for t in range(delta.shape[1] - 1, -1, -1):
        adv = delta[:, t] + gamma * lam * next_mask[:, t] * adv
        advs.append(adv)
    adv = torch.stack(advs[::-1], dim=1)                     # (B, S, M)
    return adv, adv + values


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def multi_objective_losses(cfg: ModelConfig, fc: FIRMConfig, trainable,
                           frozen, critic, batch: PPOBatch, kl_coef, *,
                           use_kernel: bool = True):
    """Stacked (M,) PPO losses + auxiliary outputs (single forward)."""
    params = merge_trainable(trainable, frozen)
    out = transformer.forward_seq(cfg, params, batch.tokens,
                                  use_kernel=use_kernel)
    lp = token_logprobs(out["logits"], batch.tokens)
    mask = batch.response_mask
    ratio = torch.exp(torch.clamp(lp - batch.old_logprobs, -20.0, 20.0))
    kl = lp - batch.ref_logprobs

    feats = critic_lib.features(out["hidden"])
    vals = critic_lib.values(critic, feats)                  # (B, S, M)
    r_tok = shaped_rewards(kl.detach(), mask, batch.rewards, kl_coef)
    adv, rets = gae(r_tok.detach(), vals.detach(), mask, fc.gamma,
                    fc.gae_lambda)
    # per-objective advantage whitening over response tokens
    n = torch.clamp(mask.sum(), min=1.0)
    mean = (adv * mask[..., None]).sum((0, 1)) / n
    var = (((adv - mean) ** 2) * mask[..., None]).sum((0, 1)) / n
    adv = (adv - mean) / torch.sqrt(var + 1e-8)

    clipped = torch.clamp(ratio, 1.0 - fc.ppo_clip, 1.0 + fc.ppo_clip)
    pg = -torch.minimum(ratio[..., None] * adv, clipped[..., None] * adv)
    losses = (pg * mask[..., None]).sum((0, 1)) / n
    losses = losses + out["aux_loss"]                        # MoE router aux

    metrics = {
        "kl": masked_mean(kl, mask).detach(),
        "ratio_mean": masked_mean(ratio, mask).detach(),
        "entropy_proxy": -masked_mean(lp, mask).detach(),
        "aux_loss": out["aux_loss"].detach(),
    }
    return losses, (metrics, feats, r_tok, rets, mask)


def per_objective_grads(cfg: ModelConfig, fc: FIRMConfig, trainable, frozen,
                        critic, batch: PPOBatch, kl_coef, *,
                        use_kernel: bool = True):
    """M gradients of the M losses w.r.t. ``trainable``: one forward, then
    M backward pulls through the one graph.

    Returns (grads: list of M trees shaped like ``trainable``, losses (M,),
    extras).  The pulls are sequential ``torch.autograd.grad`` calls (the
    kernels' ``autograd.Function``s define no vmap rule, so the batched
    pull of the reference has no counterpart here).
    """
    m = fc.n_objectives
    with torch.enable_grad():
        train = tree_map(lambda t: t.detach().requires_grad_(), trainable)
        losses, extras = multi_objective_losses(
            cfg, fc, train, frozen, critic, batch, kl_coef,
            use_kernel=use_kernel)
        leaves = tree_leaves(train)
        grads = []
        for j in range(m):
            flat = iter(torch.autograd.grad(losses[j], leaves,
                                            retain_graph=j < m - 1))
            grads.append(tree_map(lambda _: next(flat), train))
    return grads, losses.detach(), extras
