"""What one call of each Hopper kernel costs: bytes and operations.

One copy of the arithmetic that ``chip_smoke.py``'s bounds and
``launch.hlo_cost``'s per-device counter both read.  ``COSTS[name](...)``
takes a call's operands (their local shards, for a DTensor) and returns
``(bytes, operations, peak)``: each input read once and each output
written once; the operations the function needs for these shapes (a
causal or windowed attention counts the (query, key) pairs it keeps); and
the key of the H100 peak rate they run at (``PEAK_FLOPS`` of
``chip_smoke.py``: ``bf16`` and ``tf32`` on the tensor cores, ``f32`` on
the FMA pipes).

``call`` charges one call to every cost counter open in this thread (a
``launch.hlo_cost.CostCounter`` on the dispatch mode stack) and keeps the
body of the call out of their operation counts: a kernel counts once,
with the card kernel's costs, whether it launches on the card or runs as
its plain version (on the CPU or on ``meta`` tensors).  With no counter
open it does nothing.
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def local(t):
    """A DTensor's local shard, any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def nbytes(t) -> int:
    t = local(t)
    return t.numel() * t.element_size()


def numel(t) -> int:
    return local(t).numel()


def _peak(t) -> str:
    return "bf16" if t.dtype in (torch.bfloat16, torch.float16) else "f32"


@functools.lru_cache(maxsize=None)
def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head keeps: query i and key j at absolute
    positions i and j, j <= i when causal, i - j < window when a window
    is set (the plain version's mask)."""
    total = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def rmsnorm(x, g, eps: float = 1e-5):
    """x and g read, y written; 4 operations an element (square, sum,
    scale, multiply by g)."""
    return 2 * nbytes(x) + nbytes(g), 4 * numel(x), "f32"


def rmsnorm_bwd(x, g, eps: float = 1e-5, *, want_dg: bool = False):
    """x and dy read, dx written, g read (and dg written); 10 operations an
    element, 22 with dg."""
    if want_dg:
        return 3 * nbytes(x) + 2 * nbytes(g), 22 * numel(x), "f32"
    return 3 * nbytes(x) + nbytes(g), 10 * numel(x), "f32"


def _flash_pairs(q, k, causal: bool, sliding_window: int) -> int:
    b, sq, hq, _ = local(q).shape
    return b * hq * attention_pairs(sq, local(k).shape[1], bool(causal),
                                    int(sliding_window))


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """q, k, v read, o written; 4 Dh operations a kept (query, key) pair
    (QK^T and PV)."""
    dh = local(q).shape[-1]
    return (2 * nbytes(q) + nbytes(k) + nbytes(v),
            4 * dh * _flash_pairs(q, k, causal, sliding_window), _peak(q))


def flash_attention_bwd(q, k, v, *, causal: bool = True,
                        sliding_window: int = 0):
    """q, k, v, o, dO and the f32 lse read, dq, dk, dv written (o, dO and
    dq each the size of q); 10 Dh operations a kept pair (2 Dh each for
    S, dP, dV, dQ and dK)."""
    b, sq, hq, dh = local(q).shape
    return (4 * nbytes(q) + 2 * nbytes(k) + 2 * nbytes(v) + 4 * b * hq * sq,
            10 * dh * _flash_pairs(q, k, causal, sliding_window), _peak(q))


def gram(x):
    """(M, d) read, (M, M) f32 written; 2 M^2 operations a column."""
    m, d = local(x).shape
    return nbytes(x) + 4 * m * m, 2 * m * m * d, "f32"


def quantize(x2, bits):
    """x and the rounding bits read, int8 codes and an f32 scale a row
    written; 9 operations an element (|x|, max, the bits' conversion and
    scaling, the division, the addition, floor and two clips)."""
    n, rows = numel(x2), numel(x2) // local(x2).shape[-1]
    return nbytes(x2) + nbytes(bits) + n + 4 * rows, 9 * n, "f32"


def dequantize(codes, scales, adj=None):
    """codes and scales read, f32 values written; with the error-feedback
    epilogue also adj read and the residual written.  One multiply an
    element, and a fused multiply-add more with the epilogue."""
    n = numel(codes)
    if adj is None:
        return nbytes(codes) + nbytes(scales) + 4 * n, n, "f32"
    return (nbytes(codes) + nbytes(scales) + nbytes(adj) + 8 * n, 3 * n,
            "f32")


def abs_threshold_count(x2, thresh):
    """x and C thresholds read, C counts written; |x| and a compare an
    element."""
    c = numel(thresh)
    return nbytes(x2) + 8 * c, 2 * numel(x2), "f32"


def abs_threshold_mask(x2, thresh):
    """x and the thresholds read, the mask written."""
    return 2 * nbytes(x2) + 4 * numel(thresh), 2 * numel(x2), "f32"


def ssd_flops(b: int, s: int, nh: int, hd: int, ds: int, chunk: int) -> int:
    """Operations the chunked SSD scan needs for these shapes: for each
    chunk of n positions and each head, 2 hd per causal (i, j) pair
    (y_intra), 2 ds hd per position (y_inter) and as many again (the state
    update); C B^T once per batch row, 2 ds per causal pair."""
    total = 0
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        pairs = n * (n + 1) // 2
        total += b * (nh * (2 * hd * pairs + 4 * n * ds * hd)
                      + 2 * ds * pairs)
    return total


def ssd_bwd_flops(b: int, s: int, nh: int, hd: int, ds: int,
                  chunk: int) -> int:
    """Operations the SSD backward needs: per chunk and head 4 hd a causal
    pair (dS, and dx from the scores) and 10 hd ds a position (the
    chunk-start state recomputed, dy^T h0, x^T dh, dh B and the new dh);
    per chunk and batch row 6 ds a causal pair (C B^T, and dC and dB from
    the gradient of C B^T, once for the heads)."""
    total = 0
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)
        pairs = n * (n + 1) // 2
        total += b * (nh * (4 * hd * pairs + 10 * n * hd * ds)
                      + 6 * ds * pairs)
    return total


def ssd(x, bmat, cmat, dt, da, *, chunk: int = 128,
        return_state: bool = False):
    """x, B, C, dt, da read, the f32 y (and final state) written; the
    products at the TF32 tensor-core rate."""
    b, s, nh, hd = local(x).shape
    ds = local(bmat).shape[-1]
    n_bytes = (nbytes(x) + 4 * numel(x) + nbytes(bmat) + nbytes(cmat)
               + nbytes(dt) + nbytes(da))
    if return_state:
        n_bytes += 4 * b * nh * hd * ds
    return n_bytes, ssd_flops(b, s, nh, hd, ds, chunk), "tf32"


def ssd_bwd(x, bmat, cmat, dt, da, *, chunk: int = 128):
    """x, B, C, dt, da and dy read, their five f32 gradients written."""
    b, s, nh, hd = local(x).shape
    ds = local(bmat).shape[-1]
    return (4 * (3 * numel(x) + 2 * numel(bmat) + 2 * numel(cmat)
                 + 2 * numel(dt) + 2 * numel(da)),
            ssd_bwd_flops(b, s, nh, hd, ds, chunk), "tf32")


# kernel name (the launch counters' names) -> its cost
COSTS = {"rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd,
         "flash_attention": flash_attention,
         "flash_attention_bwd": flash_attention_bwd, "gram": gram,
         "quantize": quantize, "dequantize": dequantize,
         "abs_threshold_count": abs_threshold_count,
         "abs_threshold_mask": abs_threshold_mask,
         "ssd": ssd, "ssd_bwd": ssd_bwd}


def _open_counters() -> list:
    if not torch._C._len_torch_dispatch_stack():
        return []
    return [m for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "charge_kernel")]


def counting() -> bool:
    """Whether a cost counter is open in this thread."""
    return bool(_open_counters())


class call:
    """``with call(name, *operands, **params) as c:`` charges one call of
    kernel ``name`` to the open cost counters and pauses their operation
    counts for the body; ``c.made(*tensors)`` tells them of the call's
    outputs, which they track as live memory."""

    __slots__ = ("counters",)

    def __init__(self, name: str, *operands, **params):
        self.counters = _open_counters()
        if self.counters:
            cost = COSTS[name](*operands, **params)
            for m in self.counters:
                m.charge_kernel(name, *cost)

    def __enter__(self):
        for m in self.counters:
            m.paused += 1
        return self

    def __exit__(self, *exc):
        for m in self.counters:
            m.paused -= 1
        return False

    def made(self, out):
        """Track ``out`` (a tensor or a tuple of them) as the call's
        outputs; returns it."""
        for m in self.counters:
            m.track_made(out if isinstance(out, tuple) else (out,))
        return out


def charge(name: str, *operands, **params) -> None:
    """Charge one launch of kernel ``name`` to the open cost counters (the
    wrappers call it beside their launch counters)."""
    call(name, *operands, **params)
