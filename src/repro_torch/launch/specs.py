"""Shape stand-ins for every entry point: trees of ``meta`` tensors, the
reference's shapes and dtypes, nothing allocated.

Counterpart of ``repro.launch.specs``, where ``jax.eval_shape`` becomes
the ``meta`` device.  ``input_specs(cfg, shape, fc)`` returns every
argument of the step implied by the shape kind:
  train_4k    -> firm train step  (ClientState, frozen params, PPOBatch, aux)
  prefill_32k -> prefill          (params, tokens, aux)
  decode_*    -> serve step       (params, cache, token)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import FIRMConfig, InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import split_trainable
from repro_torch.rlhf import local as local_lib
from repro_torch.rlhf.ppo import PPOBatch

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``: the port's
    ``ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def seq_lens(cfg: ModelConfig, shape: InputShape):
    """(decoder_len, encoder/cross_len) for this arch at this shape."""
    if cfg.is_encoder_decoder:
        enc = shape.seq_len // cfg.encoder_len_ratio
        dec = max(8, shape.seq_len // cfg.decoder_len_ratio)
        return dec, enc
    if cfg.family == "vlm":
        return shape.seq_len, cfg.n_vision_tokens
    return shape.seq_len, 0


def aux_specs(cfg: ModelConfig, batch: int, cross_len: int,
              dtype=torch.bfloat16) -> Optional[dict]:
    """Modality-stub inputs."""
    if cfg.family == "vlm":
        return {"vision": sds((batch, cross_len, cfg.d_model), dtype)}
    if cfg.is_encoder_decoder:
        return {"frames": sds((batch, cross_len, cfg.d_model), dtype)}
    return None


def param_specs(cfg: ModelConfig, dtype=torch.bfloat16):
    return transformer.init_params(cfg, generator=torch.Generator(),
                                   device=META, dtype=dtype)


def state_specs(cfg: ModelConfig, fc: FIRMConfig, dtype=torch.bfloat16):
    """(ClientState specs, frozen specs), on ``meta``."""
    trainable, frozen = split_trainable(param_specs(cfg, dtype))
    state = local_lib.init_client_state(trainable, fc.n_objectives,
                                        cfg.d_model, fc.kl_coef_init,
                                        device=META)
    return state, frozen


def train_batch_specs(cfg: ModelConfig, fc: FIRMConfig, shape: InputShape):
    b = shape.global_batch
    s, cross = seq_lens(cfg, shape)
    batch = PPOBatch(
        tokens=sds((b, s), torch.int32),
        response_mask=sds((b, s), torch.float32),
        old_logprobs=sds((b, s), torch.float32),
        ref_logprobs=sds((b, s), torch.float32),
        rewards=sds((b, fc.n_objectives), torch.float32),
    )
    return batch, aux_specs(cfg, b, cross)


def prefill_specs(cfg: ModelConfig, shape: InputShape):
    b = shape.global_batch
    s, cross = seq_lens(cfg, shape)
    return sds((b, s), torch.int32), aux_specs(cfg, b, cross)


def cache_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16):
    b = shape.global_batch
    s, cross = seq_lens(cfg, shape)
    return transformer.init_cache(cfg, b, s, device=META, dtype=dtype,
                                  n_cross=cross)


def decode_specs(cfg: ModelConfig, shape: InputShape):
    b = shape.global_batch
    return (param_specs(cfg), cache_specs(cfg, shape),
            sds((b, 1), torch.int32))


def input_specs(cfg: ModelConfig, shape: InputShape,
                fc: Optional[FIRMConfig] = None) -> dict:
    """Every input of the step for this (arch, shape) pair."""
    fc = fc or FIRMConfig()
    if shape.kind == "train":
        state, frozen = state_specs(cfg, fc)
        batch, aux = train_batch_specs(cfg, fc, shape)
        return {"kind": "train", "state": state, "frozen": frozen,
                "batch": batch, "aux": aux}
    if shape.kind == "prefill":
        tokens, aux = prefill_specs(cfg, shape)
        return {"kind": "prefill", "params": param_specs(cfg),
                "tokens": tokens, "aux": aux}
    params, cache, token = decode_specs(cfg, shape)
    return {"kind": "decode", "params": params, "cache": cache,
            "token": token}
