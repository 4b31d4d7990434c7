"""Magnitude top-k sparsification codec (counterpart of
``repro.comms.sparsify``).

Sends the k = frac * d largest-magnitude entries as (int32 index, f32
value) pairs: 64 bits a kept parameter, so frac = 0.05 is ~10% of
identity.  Top-k is biased; pair it with error feedback ("topk:0.05+ef").

Selection follows the reference: a bracket (lo, hi) of the k-th largest
magnitude from 32 bisection passes of the threshold count
(``kernels.ops.topk_threshold``; on CUDA one kernel launch a pass over all
clients), then a stable argsort of each entry's category (definite member,
boundary tie, dropped), the first k, sorted ascending.  The argsort and the
gather are plain PyTorch ops, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.comms.codec import Codec
from repro_torch.comms.quantize import _stacked_blocks
from repro_torch.kernels import ops


def support_in_bracket(flats: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, k: int):
    """(C, d) rows and their (C,) brackets -> (indices (C, k) int32 sorted
    ascending, values (C, k)).

    ``|x| >= hi`` are definite members (fewer than k unless every entry
    ties at the max), entries in [lo, hi) boundary ties that fill the
    remaining slots in index order, the rest (NaN too) dropped: category
    0, 1 or 2, and a stable argsort puts them in that order.
    """
    absx = flats.abs()
    cat = (2 - (absx >= lo[:, None]).to(torch.uint8)
           - (absx >= hi[:, None]).to(torch.uint8))
    idx = torch.argsort(cat, dim=1, stable=True)[:, :k].sort(dim=1).values
    return idx.to(torch.int32), flats.gather(1, idx)


def topk_support_stacked(flats: torch.Tensor, k: int,
                         use_kernel: bool = True):
    """The k largest |entries| of each of the C rows of ``flats``: one
    batched bisection for all rows.  ``use_kernel=False`` takes
    ``torch.topk`` instead (the reference's ``lax.top_k`` path, for the
    tests; ties may resolve otherwise there)."""
    c, d = flats.shape
    k = max(1, min(int(k), d))
    if not use_kernel:
        idx = torch.topk(flats.abs(), k, dim=1).indices.sort(dim=1).values
        return idx.to(torch.int32), flats.gather(1, idx)
    x, rows = _stacked_blocks(flats)
    lo, hi = ops.topk_threshold(x.view(c, rows, -1), k)
    return support_in_bracket(flats, lo, hi, k)


def topk_support(flat: torch.Tensor, k: int, use_kernel: bool = True):
    """Indices (sorted ascending, int32) and values of the k largest
    |entries| of one (d,) vector."""
    idx, vals = topk_support_stacked(flat[None], k, use_kernel)
    return idx[0], vals[0]


class TopKCodec(Codec):
    def __init__(self, frac: float = 0.05, use_kernel: bool = True):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk frac must be in (0, 1], got {frac}")
        self.frac = frac
        self.use_kernel = use_kernel
        self.name = f"topk:{frac:g}"

    def _k(self, d: int) -> int:
        return max(1, int(round(self.frac * d)))

    def encode_flat(self, flat, *, key=None, bits=None):
        k = self._k(flat.numel())
        idx, vals = topk_support(flat, k, self.use_kernel)
        return {"indices": idx, "values": vals.float()}, {"k": k}

    def decode_flat(self, payload):
        idx = payload.arrays["indices"]
        out = torch.zeros(payload.meta["d"], dtype=torch.float32,
                          device=idx.device)
        out[idx.long()] = payload.arrays["values"]
        return out

    def bits_per_param(self, d: int) -> float:
        return 64.0 * self.frac

    def nbytes_static(self, d: int) -> int:
        # k (int32 index, f32 value) pairs; k depends on d alone
        return 8 * self._k(d)

    def meta_static(self, d: int):
        return {"k": self._k(d)}

    def encode_decode_traced_stacked(self, flats, *, keys=None, bits=None):
        """All C rows in one batched bisection: (indices and values (C,
        k), decoded (C, d)); the keys and bits are not read (selection is
        deterministic), and row c is the row's own selection."""
        c, d = flats.shape
        idx, vals = topk_support_stacked(flats, self._k(d), self.use_kernel)
        vals = vals.float()
        decoded = torch.zeros((c, d), dtype=torch.float32,
                              device=flats.device)
        decoded.scatter_(1, idx.long(), vals)
        return {"indices": idx, "values": vals}, decoded

    def encode_decode_traced(self, flat, *, key=None, bits=None):
        arrays, decoded = self.encode_decode_traced_stacked(flat[None])
        return {k: v[0] for k, v in arrays.items()}, decoded[0]
