"""The federated engine's rollout (counterpart of part of ``repro.fed.engine``).

``rollout_batch`` is what every FIRM local step runs before any gradient:
generation (prefill, then decode and sample), banded rewards, and the
frozen reference model's logprobs.  It is the counterpart of
``FederatedTrainer._make_batch`` and of the first lines of ``one_client``
in ``_make_round_fn``.  The trainer grows around it in the training
slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.rlhf import ppo, rewards as rewards_lib
from repro_torch.rlhf.sampling import generate


@torch.no_grad()
def rollout_batch(cfg: ModelConfig, params, ref_params, prompts: torch.Tensor,
                  band_h, band_x, *, n_objectives: int, max_new: int,
                  length_tol: int,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None) -> ppo.PPOBatch:
    """(B, P) prompts -> ``PPOBatch`` of (B, P + max_new) rows.

    ``params`` is the client's policy (adapters merged), ``ref_params`` the
    frozen reference.  ``band_h``/``band_x`` are the (lo, hi) helpful and
    harmful bands of ``rewards.variant_bands``.  The sampling noise comes
    from ``generator`` or is injected as ``gumbel`` (max_new, B, V).
    """
    tokens, old_lp, mask = generate(cfg, params, prompts, max_new=max_new,
                                    generator=generator, gumbel=gumbel)
    r = rewards_lib.score_batch_banded(band_h, band_x, tokens, mask,
                                       n_objectives, length_tol)
    ref_out = transformer.forward_seq(cfg, ref_params, tokens)
    ref_lp = ppo.token_logprobs(ref_out["logits"], tokens)
    return ppo.PPOBatch(tokens, mask, old_lp, ref_lp, r)
