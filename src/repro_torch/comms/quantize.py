"""Blockwise int8 / int4 stochastic quantization codecs (counterpart of
``repro.comms.quantize``).

The flat vector is zero-padded to (rows, 1024) groups; each group carries
one f32 scale.  int8 sends the codes raw (1 byte a parameter); int4 packs
two codes a byte.  Stochastic rounding (uniform uint32 offsets) keeps the
quantizer unbiased; without a key, or with ``stochastic=False``, the
offset is 2**31, round to nearest.  On CUDA tensors the quantize and
dequantize kernels run (``kernels.ops``), on CPU ones their plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.comms.codec import Codec, _rows
from repro_torch.kernels import ops
from repro_torch.kernels.quantize import BLOCK

# the int32 pattern of the uint32 offset 2**31, whose [0, 1) image is
# exactly 0.5: round to nearest
DET_BITS = -2 ** 31


def _to_blocks(flat: torch.Tensor) -> torch.Tensor:
    """(d,) -> (rows, BLOCK) f32, zero-padded to whole rows."""
    return _stacked_blocks(flat[None])[0]


def _stacked_blocks(flats: torch.Tensor):
    """(C, d) -> ((C * rows, BLOCK) f32 zero-padded, rows): each client's
    rows follow the previous client's."""
    c, d = flats.shape
    rows = -(-d // BLOCK)
    x = F.pad(flats.float(), (0, rows * BLOCK - d))
    return x.reshape(c * rows, BLOCK).contiguous(), rows


def random_bits(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform uint32 rounding offsets as int32 bit patterns, drawn from
    ``generator`` on its device."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         generator=generator, device=generator.device)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7] -> uint8, two nibbles a byte (even index
    high)."""
    u = (codes.to(torch.int32) + 8).to(torch.uint8)             # [1, 15]
    return (u[..., 0::2] << 4) | u[..., 1::2]


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    lo = (packed >> 4).to(torch.int32) - 8
    hi = (packed & 0xF).to(torch.int32) - 8
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], -1).to(torch.int8)


class QuantizeCodec(Codec):
    """bits=8 -> raw int8 codes; bits=4 -> nibble-packed uint8 codes."""

    def __init__(self, bits: int = 8, stochastic: bool = True):
        if bits not in (4, 8):
            raise ValueError(f"quantize bits must be 4 or 8, got {bits}")
        self.bits = bits
        self.qmax = 7 if bits == 4 else 127
        self.stochastic = stochastic
        self.name = f"int{bits}"

    def _rounding_bits(self, rows: int, key, bits, device) -> torch.Tensor:
        """One client's (rows, BLOCK) offsets: the injected ``bits``, a draw
        from the generator ``key``, or round to nearest."""
        if self.stochastic and bits is not None:
            return bits.to(device=device, dtype=torch.int32)
        if self.stochastic and key is not None:
            return random_bits((rows, BLOCK), key)
        return torch.full((rows, BLOCK), DET_BITS, dtype=torch.int32,
                          device=device)

    def encode_flat(self, flat, *, key=None, bits=None):
        x2 = _to_blocks(flat)
        rbits = self._rounding_bits(x2.shape[0], key, bits, x2.device)
        codes, scales = ops.quantize(x2, rbits, self.qmax)
        if self.bits == 4:
            codes = pack_int4(codes)
        return {"codes": codes, "scales": scales}, {"bits": self.bits}

    def decode_flat(self, payload):
        codes = payload.arrays["codes"]
        if payload.meta["bits"] == 4:
            codes = unpack_int4(codes)
        return self._dequantize(codes, payload.arrays["scales"])[0] \
            .reshape(-1)

    def bits_per_param(self, d: int) -> float:
        return self.bits + 32.0 / BLOCK

    def nbytes_static(self, d: int) -> int:
        # padded (rows, BLOCK) codes (int8: 1 byte, int4: packed nibbles)
        # plus one f32 scale a row: the measured Payload layout
        rows = -(-d // BLOCK)
        return rows * (BLOCK if self.bits == 8 else BLOCK // 2) + rows * 4

    def meta_static(self, d: int):
        return {"bits": self.bits}

    # -- stacked-client path: one launch over all clients' rows -----------
    def _quantize_stacked(self, flats, keys=None, bits=None):
        """(C, d) -> (codes, scales, x) from ONE quantize over the
        clients' concatenated rows ``x`` (C * rows, BLOCK); rows are
        independent, so each client's codes are those of its own encode.
        ``keys``: one generator (or None: round to nearest) per client;
        ``bits``: the injected (C, rows, BLOCK) draws instead."""
        x, rows = _stacked_blocks(flats)
        keys, row_bits = _rows(flats.shape[0], keys, bits)
        rbits = torch.cat([self._rounding_bits(rows, k, b, x.device)
                           for k, b in zip(keys, row_bits)])
        codes, scales = ops.quantize(x, rbits, self.qmax)
        return codes, scales, x

    @staticmethod
    def _dequantize(codes, scales, adj=None):
        """(decoded, residual or None): one launch on CUDA, with the
        error-feedback epilogue when ``adj`` is given."""
        if adj is None:
            return ops.dequantize(codes, scales), None
        return ops.dequantize_with_residual(codes, scales, adj)

    def _wire(self, codes, scales):
        """The concatenated rows' wire buffers: int4 codes packed."""
        return {"codes": pack_int4(codes) if self.bits == 4 else codes,
                "scales": scales}

    def encode_decode_traced_stacked(self, flats, *, keys=None, bits=None):
        """One quantize and one dequantize launch over all C clients'
        rows: (wire buffers in the concatenated-row layout, decoded (C,
        d)).  Row c is ``encode_decode_traced(flats[c], key=keys[c])``."""
        c, d = flats.shape
        codes, scales, _ = self._quantize_stacked(flats, keys, bits)
        decoded = self._dequantize(codes, scales)[0]
        return self._wire(codes, scales), decoded.reshape(c, -1)[:, :d]

    def encode_decode_residual_traced_stacked(self, adj, *, keys=None,
                                              bits=None):
        """One quantize launch over all rows, then one dequantize launch
        whose epilogue writes the residual ``fma(-code, scale, adj)``."""
        c, d = adj.shape
        codes, scales, x = self._quantize_stacked(adj, keys, bits)
        decoded, residual = self._dequantize(codes, scales, adj=x)
        return (self._wire(codes, scales), decoded.reshape(c, -1)[:, :d],
                residual.reshape(c, -1)[:, :d])

    def encode_decode_traced(self, flat, *, key=None, bits=None):
        arrays, decoded = self.encode_decode_traced_stacked(
            flat[None], keys=[key], bits=None if bits is None else bits[None])
        return arrays, decoded[0]

    def stacked_payloads_from_arrays(self, arrays, c, spec, d):
        """Slice the concatenated rows into per-client Payloads: the
        layout (and bytes) of per-client encodes."""
        rows = -(-d // BLOCK)
        return [self.payload_from_arrays(
            {k: v[i * rows:(i + 1) * rows] for k, v in arrays.items()},
            spec, d) for i in range(c)]

    def encode_stacked(self, flats, spec, states=None, *, keys=None,
                       bits=None):
        payloads, states, _ = self.roundtrip_stacked(flats, spec, states,
                                                     keys=keys, bits=bits)
        return payloads, states
