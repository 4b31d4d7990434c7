"""One client's local phase of the federated engine (counterpart of part of
``repro.fed.engine``).

``rollout_batch`` is what every FIRM local step runs before any gradient:
generation (prefill, then decode and sample), banded rewards, and the
frozen reference model's logprobs.  It is the counterpart of
``FederatedTrainer._make_batch`` and of the first lines of ``one_client``
in ``_make_round_fn``.  ``client_local_steps`` runs K local steps of one
client, each a rollout then ``firm_local_step``: the counterpart of
``one_client`` and the scan ``body`` of ``_make_round_fn`` for a single
client, without the vmap over clients.  The vectorized round, FedAvg and
the codecs come with the next slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import FIRMConfig, ModelConfig
from repro_torch.data.prompts import PromptDataset
from repro_torch.models import transformer
from repro_torch.models.common import merge_trainable
from repro_torch.rlhf import local as local_lib
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


def client_local_steps(cfg: ModelConfig, fc: FIRMConfig,
                       state: local_lib.ClientState, frozen, ref_params,
                       band_h, band_x, *, k_steps: int, max_new: int,
                       length_tol: int,
                       dataset: Optional[PromptDataset] = None,
                       prompts: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None):
    """K local FIRM steps of one client.  Returns (final state, metrics).

    Each step merges the client's adapters into ``frozen``, rolls out
    ``fc.batch_size`` prompts and runs ``firm_local_step``.  Prompts come
    from ``dataset`` or are injected as ``prompts`` (K, B, P); the sampling
    noise comes from ``generator`` or is injected as ``gumbel``
    (K, max_new, B, V).  The metrics are the reference's per-step keep:
    ``lam`` (K, M), ``rewards`` (K, M) and ``kl`` (K,).
    """
    if (dataset is None) == (prompts is None):
        raise ValueError("pass exactly one of dataset= and prompts=")
    kept = {"lam": [], "rewards": [], "kl": []}
    for k in range(k_steps):
        params = merge_trainable(state.trainable, frozen)
        p = (dataset.next_batch(fc.batch_size) if prompts is None
             else prompts[k])
        batch = rollout_batch(cfg, params, ref_params, p, band_h, band_x,
                              n_objectives=fc.n_objectives, max_new=max_new,
                              length_tol=length_tol, generator=generator,
                              gumbel=None if gumbel is None else gumbel[k])
        state, metrics = local_lib.firm_local_step(cfg, fc, state, frozen,
                                                   batch)
        for key, vals in kept.items():
            vals.append(metrics[key])
    return state, {key: torch.stack(vals) for key, vals in kept.items()}
