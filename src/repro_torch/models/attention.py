"""GQA attention for the transformer: sequence and decode paths, full
causal or sliding-window.

Counterpart of ``repro.models.attention``.  The sequence path calls the
flash-attention kernel through ``kernels.ops`` (the JAX model calls its
XLA twin ``chunked_attention`` instead), window included.  The kernel
keeps ``q * scale`` and the probabilities in f32, as the Pallas kernel
does, where the JAX twin rounds both to bf16: in bf16 the two models
therefore agree to a bf16 tolerance, not bit for bit.

The decode path has no Pallas kernel in the reference and stays plain
PyTorch, with the reference's rounding: ``q * scale`` in the cache dtype,
scores accumulated in f32, probabilities cast to the cache dtype before
the product with V.  Its position is a 0-d int32 tensor on the cache's
device, as in the reference, and the slots' positions and the mask are
computed from it there, so that a captured decode step reads the
position of the step it replays.  A sliding-window layer's cache may be a
ring of C slots, each holding the absolute position ``cache_positions``
names.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, sliding_window: int = 0,
                      use_kernel: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, Dh); k, v: (B, S, Hkv, Dh) at positions 0..S-1; a
    window keeps the keys j with i - j < window."""
    return ops.flash_attention(q, k, v, causal=causal,
                               sliding_window=sliding_window,
                               use_kernel=use_kernel)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *, sliding_window: int = 0,
                     cache_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, Hq, Dh); caches: (B, C, Hkv, Dh); pos: the current position,
    a 0-d int32 tensor on the caches' device (compared there: no host
    sync).  ``cache_positions`` (C,) holds each slot's absolute position
    (default: slot j holds position j; -1 marks an unwritten ring slot);
    a slot is seen when its position is in [0, pos] and, with a window,
    pos - position < window.
    """
    b, _, hq, dh = q.shape
    c, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = (q * dh ** -0.5).reshape(b, hkv, hq // hkv, dh)        # (B,Hkv,G,Dh)
    # bf16 -> f32 is exact, so these products accumulate bf16 inputs in f32
    s = qg.float() @ k_cache.permute(0, 2, 3, 1).float()       # (B,Hkv,G,C)
    if cache_positions is None:
        cache_positions = torch.arange(c, device=q.device)
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if sliding_window:
        valid &= pos - cache_positions < sliding_window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p.to(v_cache.dtype).float() @ v_cache.permute(0, 2, 1, 3).float()
    return out.reshape(b, 1, hq, dh).to(q.dtype)
