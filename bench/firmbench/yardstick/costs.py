"""Bytes and operations of one call of the system's hand-written
kernels, from shapes alone: a frozen copy of the arithmetic the system
keeps for its own bounds, so that a later change to the system cannot
move the benchmark's yardstick.

Each function returns (bytes, operations, peak): every input read once
and every output written once; the operations the function needs at
these shapes (an attention counts the (query, key) pairs it keeps); the
key of the H100 rate the operations run at (``peaks.FLOPS``).
"""
from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head keeps: query i and key j at positions
    i and j, j <= i when causal, i - j < window when a window is set."""
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_attention(b, sq, skv, hq, hkv, dh, *, causal=True, window=0,
                    itemsize=2):
    """q, k, v read, o written; 4 Dh operations a kept pair."""
    q = b * sq * hq * dh * itemsize
    kv = b * skv * hkv * dh * itemsize
    pairs = b * hq * attention_pairs(sq, skv, causal, window)
    return 2 * q + 2 * kv, 4 * dh * pairs, "bf16" if itemsize == 2 else "f32"


def flash_attention_bwd(b, sq, skv, hq, hkv, dh, *, causal=True, window=0,
                        itemsize=2):
    """q, k, v, o, dO and the f32 lse read, dq, dk, dv written; 10 Dh
    operations a kept pair."""
    q = b * sq * hq * dh * itemsize
    kv = b * skv * hkv * dh * itemsize
    pairs = b * hq * attention_pairs(sq, skv, causal, window)
    return (4 * q + 4 * kv + 4 * b * hq * sq, 10 * dh * pairs,
            "bf16" if itemsize == 2 else "f32")


def ssd_flops(b, s, nh, hd, ds, chunk):
    """Operations of the chunked SSD scan: per chunk of n and head, 2 hd
    a causal pair, 4 ds hd a position; C B^T once a row, 2 ds a pair."""
    total = 0
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        pairs = n * (n + 1) // 2
        total += b * (nh * (2 * hd * pairs + 4 * n * ds * hd)
                      + 2 * ds * pairs)
    return total


def ssd_bwd_flops(b, s, nh, hd, ds, chunk):
    """Operations of the SSD backward: per chunk and head 4 hd a causal
    pair and 10 hd ds a position; per chunk and row 6 ds a pair."""
    total = 0
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        pairs = n * (n + 1) // 2
        total += b * (nh * (4 * hd * pairs + 10 * n * hd * ds)
                      + 6 * ds * pairs)
    return total


def ssd(b, s, nh, hd, ds, *, chunk=128, itemsize=4, return_state=False):
    """x, B, C, dt, da read, the f32 y (and final state) written; the
    products at the TF32 tensor-core rate."""
    x = b * s * nh * hd
    n_bytes = (x * itemsize + 4 * x + 2 * b * s * ds * itemsize
               + 2 * b * s * nh * itemsize)
    if return_state:
        n_bytes += 4 * b * nh * hd * ds
    return n_bytes, ssd_flops(b, s, nh, hd, ds, chunk), "tf32"


def ssd_bwd(b, s, nh, hd, ds, *, chunk=128):
    """x, B, C, dt, da and dy read, their five f32 gradients written."""
    x = b * s * nh * hd
    return (4 * (3 * x + 4 * b * s * ds + 4 * b * s * nh),
            ssd_bwd_flops(b, s, nh, hd, ds, chunk), "tf32")
