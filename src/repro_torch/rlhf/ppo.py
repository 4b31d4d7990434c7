"""PPO batch and token logprobs (counterpart of part of ``repro.rlhf.ppo``).

The multi-objective losses and their gradients arrive with the training
slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
