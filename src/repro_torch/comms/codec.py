"""Codec protocol and payload container of the federated links
(counterpart of ``repro.comms.codec``).

A ``Codec`` turns a flat f32 vector (a tree flattened in sorted-key leaf
order, ``tree_to_flat``) into a ``Payload``: the buffers that would cross
the wire, whose ``nbytes`` is measured from their dtypes (int8 codes count
1 byte, packed int4 nibbles half a byte).  Codecs are stateless; the
per-client error-feedback residual is threaded through explicitly, so one
codec serves every client:

    payload, state, decoded = codec.roundtrip_flat(flat, spec, state,
                                                   key=generator)

Randomness is explicit: where the reference takes a PRNG key, the port
takes ``key``, a ``torch.Generator`` on the flat vector's device, or the
draw itself injected as ``bits`` (the uint32 rounding offsets as an int32
tensor of their bit patterns), so that a test can hand the port JAX's
draws.

Every codec of the reference's registry is ported: ``IdentityCodec``,
``QuantizeCodec`` (``comms.quantize``), ``TopKCodec`` (``comms.sparsify``),
``LowRankCodec`` (``comms.lowrank``), ``ErrorFeedback`` around any lossy
codec and ``DeltaCodec`` around any codec, at the host boundary
(``roundtrip*``).  ``nbytes_entropy`` and the traced API of the
reference's fused executor (``roundtrip_traced*``, ``init_state(s)_traced``)
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import trees


@dataclasses.dataclass
class Payload:
    """What crosses the wire: named buffers and static metadata (the tree
    layout and codec parameters, excluded from the byte count)."""
    kind: str
    arrays: Dict[str, torch.Tensor]
    meta: Dict[str, Any]

    @property
    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size()
                       for a in self.arrays.values()))


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Enough structure to rebuild a tree from a flat f32 vector:
    ``treedef`` is a tree of the same structure (leaves are placeholders),
    ``shapes`` and ``dtypes`` its leaves' in sorted-key order."""
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]

    @property
    def size(self) -> int:
        return sum(math.prod(s) for s in self.shapes)


def tree_to_flat(tree) -> Tuple[torch.Tensor, TreeSpec]:
    leaves = trees.tree_leaves(tree)
    spec = TreeSpec(trees.tree_map(lambda _: 0, tree),
                    tuple(tuple(t.shape) for t in leaves),
                    tuple(t.dtype for t in leaves))
    return torch.cat([t.float().reshape(-1) for t in leaves]), spec


def flat_to_tree(flat: torch.Tensor, spec: TreeSpec):
    leaves, off = [], 0
    for shape, dtype in zip(spec.shapes, spec.dtypes):
        n = math.prod(shape)
        leaves.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    return trees.tree_unflatten(spec.treedef, leaves)


class Codec:
    """Base codec: subclasses implement the flat-vector transform."""

    name = "codec"
    # what the reference's Codec declares for every codec: the planner's
    # ``resolve_fused`` reads it (the traced contract itself, which only
    # the fused executor runs, is not ported yet)
    traceable = True

    # -- flat-vector transform (override) -------------------------------
    def encode_flat(self, flat: torch.Tensor, *, key=None, bits=None):
        """(d,) f32 -> (buffers, meta)."""
        raise NotImplementedError

    def decode_flat(self, payload: Payload) -> torch.Tensor:
        """Payload -> flat f32, possibly padded past d."""
        raise NotImplementedError

    def bits_per_param(self, d: int) -> float:
        raise NotImplementedError

    def nbytes_static(self, d: int) -> int:
        """Exact wire bytes of one payload for a d-element flat vector
        (equal to ``Payload.nbytes``: every ported layout depends on d
        alone)."""
        raise NotImplementedError

    def meta_static(self, d: int) -> Dict[str, Any]:
        """The ``encode_flat`` meta dict for a d-element flat vector."""
        return {}

    def _flat_payload(self, flat, spec, *, key=None, bits=None) -> Payload:
        arrays, meta = self.encode_flat(flat, key=key, bits=bits)
        return Payload(self.name, arrays,
                       {**meta, "spec": spec, "d": int(flat.numel())})

    # -- tree API --------------------------------------------------------
    def encode(self, tree, state=None, *, key=None, bits=None):
        flat, spec = tree_to_flat(tree)
        return self._flat_payload(flat, spec, key=key, bits=bits), state

    def decode(self, payload: Payload):
        flat = self.decode_flat(payload)[:payload.meta["d"]]
        return flat_to_tree(flat, payload.meta["spec"])

    def roundtrip(self, tree, state=None, *, key=None, bits=None):
        """encode, and what the receiver decodes: (payload, new_state,
        decoded tree)."""
        payload, new_state = self.encode(tree, state, key=key, bits=bits)
        return payload, new_state, self.decode(payload)

    # -- flat and stacked API ------------------------------------------------
    def roundtrip_flat(self, flat, spec: TreeSpec, state=None, *, key=None,
                       bits=None):
        """One client's (d,) row: (payload, new_state, decoded (d,))."""
        payload = self._flat_payload(flat, spec, key=key, bits=bits)
        return payload, state, self.decode_flat(payload)[:flat.numel()]

    def roundtrip_stacked(self, flats, spec: TreeSpec, states=None, *,
                          keys=None, bits=None):
        """``roundtrip_flat`` over the C rows of (C, d) ``flats``:
        (payloads, new_states, decoded (C, d)).  ``keys`` holds one
        generator (or None) per row; ``bits`` the rows' injected draws,
        stacked.  This base version loops; the quantize and top-k codecs
        override it with one batched pass over all rows."""
        c = flats.shape[0]
        states = list(states) if states is not None else [None] * c
        keys = list(keys) if keys is not None else [None] * c
        out = [self.roundtrip_flat(flats[i], spec, states[i], key=keys[i],
                                   bits=None if bits is None else bits[i])
               for i in range(c)]
        return ([p for p, _, _ in out], [s for _, s, _ in out],
                torch.stack([dec for _, _, dec in out]))

    def ef_roundtrip_stacked(self, adj, spec: TreeSpec, *, keys=None,
                             bits=None):
        """The stateless roundtrip of (C, d) ``adj`` with the
        error-feedback residual ``adj - decoded``: (payloads, decoded,
        residual), as ``ErrorFeedback`` needs it.  The quantize codec
        overrides it to write the residual in its dequantize launch."""
        payloads, _, decoded = self.roundtrip_stacked(adj, spec, keys=keys,
                                                      bits=bits)
        return payloads, decoded, adj - decoded

    def roundtrip_traced(self, flat, state=(), *, key=None):
        """The reference's in-graph codec contract, which only its fused
        executor uses: not ported yet."""
        raise NotImplementedError(
            f"{self.name}: the traced codec contract (roundtrip_traced*) "
            f"is not ported yet")


class IdentityCodec(Codec):
    """Raw f32: the baseline every ratio is against."""

    name = "identity"

    def encode_flat(self, flat, *, key=None, bits=None):
        return {"values": flat.float()}, {}

    def decode_flat(self, payload):
        return payload.arrays["values"]

    def bits_per_param(self, d: int) -> float:
        return 32.0

    def nbytes_static(self, d: int) -> int:
        return 4 * d


class ErrorFeedback(Codec):
    """Client-local residual around a lossy codec (the standard EF trick).

    The state is the client's residual flat vector (None = zeros).  The
    client encodes ``adj = flat + residual`` through the inner codec and
    keeps ``adj - decoded`` as its next residual; the server only ever
    decodes.  The inner codec computes the residual with its roundtrip
    (``Codec.ef_roundtrip_stacked``): the quantize codec in its dequantize
    launch, as one fused multiply-subtract, which is how XLA computes the
    reference's residual (see ``kernels.ref.dequantize_residual``); every
    other codec as the difference, exact for top-k (kept entries give 0,
    dropped ones ``adj``).  A row whose key is None rounds to nearest, as
    the reference's per-row fallback does.
    """

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name + "+ef"

    def encode(self, tree, state=None, *, key=None, bits=None):
        payload, residual, _ = self.roundtrip(tree, state, key=key,
                                              bits=bits)
        return payload, residual

    def roundtrip(self, tree, state=None, *, key=None, bits=None):
        flat, spec = tree_to_flat(tree)
        payload, residual, decoded = self.roundtrip_flat(
            flat, spec, state, key=key, bits=bits)
        return payload, residual, flat_to_tree(decoded, spec)

    def roundtrip_flat(self, flat, spec, state=None, *, key=None, bits=None):
        payloads, states, decoded = self.roundtrip_stacked(
            flat[None], spec, [state], keys=[key],
            bits=None if bits is None else bits[None])
        return payloads[0], states[0], decoded[0]

    def roundtrip_stacked(self, flats, spec, states=None, *, keys=None,
                          bits=None):
        c = flats.shape[0]
        states = list(states) if states is not None else [None] * c
        adj = flats + torch.stack([torch.zeros_like(flats[i]) if s is None
                                   else s for i, s in enumerate(states)])
        payloads, decoded, residual = self.inner.ef_roundtrip_stacked(
            adj, spec, keys=keys, bits=bits)
        return payloads, [residual[i] for i in range(c)], decoded

    def decode(self, payload):
        return self.inner.decode(payload)

    def encode_flat(self, flat, *, key=None, bits=None):
        return self.inner.encode_flat(flat, key=key, bits=bits)

    def decode_flat(self, payload):
        return self.inner.decode_flat(payload)

    def bits_per_param(self, d: int) -> float:
        return self.inner.bits_per_param(d)

    def nbytes_static(self, d: int) -> int:
        return self.inner.nbytes_static(d)

    def meta_static(self, d: int):
        return self.inner.meta_static(d)


class DeltaCodec(Codec):
    """Broadcast the delta against the last round's reconstruction (the
    downlink), as ``repro.comms.codec.DeltaCodec``.

    The server encodes theta_t - ref_{t-1} through the inner codec, and
    both ends move their reference to the reconstruction ref_t = ref_{t-1}
    + decoded, so a lossy inner codec never lets them drift apart.  The
    first transmission (no reference yet) carries the full parameters.
    The state is (reference flat vector, inner codec state).  Decoding
    needs the receiver's reference, so only the ``roundtrip*`` API works;
    a bare ``decode`` raises.  The subtraction and the addition are one f32
    rounding each, as the reference's eager ones are.
    """

    def __init__(self, inner):
        self.inner = inner
        self.name = "delta+" + inner.name

    def roundtrip_flat(self, flat, spec, state=None, *, key=None, bits=None):
        ref, inner_state = (None, None) if state is None else state
        base = torch.zeros_like(flat) if ref is None else ref
        payload, inner_state, dec_delta = self.inner.roundtrip_flat(
            flat - base, spec, inner_state, key=key, bits=bits)
        decoded = base + dec_delta
        return payload, (decoded, inner_state), decoded

    def roundtrip(self, tree, state=None, *, key=None, bits=None):
        flat, spec = tree_to_flat(tree)
        payload, new_state, decoded = self.roundtrip_flat(
            flat, spec, state, key=key, bits=bits)
        return payload, new_state, flat_to_tree(decoded, spec)

    def encode(self, tree, state=None, *, key=None, bits=None):
        payload, new_state, _ = self.roundtrip(tree, state, key=key,
                                               bits=bits)
        return payload, new_state

    def decode_flat(self, payload):
        # Codec.decode calls this, so a bare decode raises too
        raise NotImplementedError(
            "delta codec reconstruction needs the receiver's reference; "
            "use roundtrip/roundtrip_flat")

    def bits_per_param(self, d: int) -> float:
        return self.inner.bits_per_param(d)

    def nbytes_static(self, d: int) -> int:
        return self.inner.nbytes_static(d)

    def meta_static(self, d: int):
        return self.inner.meta_static(d)
