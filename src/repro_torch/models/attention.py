"""GQA attention for the dense transformer: sequence and decode paths.

Counterpart of ``repro.models.attention``.  The sequence path calls the
flash-attention kernel through ``kernels.ops`` (the JAX model calls its
XLA twin ``chunked_attention`` instead).  The kernel keeps ``q * scale``
and the probabilities in f32, as the Pallas kernel does, where the JAX
twin rounds both to bf16: in bf16 the two models therefore agree to a
bf16 tolerance, not bit for bit.

The decode path has no Pallas kernel in the reference and stays plain
PyTorch, with the reference's rounding: ``q * scale`` in the cache dtype,
scores accumulated in f32, probabilities cast to the cache dtype before
the product with V.  Its position is a 0-d int32 tensor on the cache's
device, as in the reference, so that a captured decode step reads the
position of the step it replays.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, use_kernel: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, Dh); k, v: (B, S, Hkv, Dh) at positions 0..S-1."""
    return ops.flash_attention(q, k, v, causal=causal, use_kernel=use_kernel)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor
                     ) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, Hq, Dh); caches: (B, C, Hkv, Dh) with slot j holding
    position j; pos: the current position, a 0-d int32 tensor on the
    caches' device (compared there: no host sync).  The sliding-window ring cache of
    the reference comes with the sliding-window block kinds.
    """
    b, _, hq, dh = q.shape
    c, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = (q * dh ** -0.5).reshape(b, hkv, hq // hkv, dh)        # (B,Hkv,G,Dh)
    # bf16 -> f32 is exact, so these products accumulate bf16 inputs in f32
    s = qg.float() @ k_cache.permute(0, 2, 3, 1).float()       # (B,Hkv,G,C)
    valid = torch.arange(c, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p.to(v_cache.dtype).float() @ v_cache.permute(0, 2, 1, 3).float()
    return out.reshape(b, 1, hq, dh).to(q.dtype)
