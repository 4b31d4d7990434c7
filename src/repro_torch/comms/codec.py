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
codec and ``DeltaCodec`` around any codec.

Two contracts share one code path.  The host boundary (``roundtrip*``)
hands back ``Payload``s and host-format states (None for "nothing yet").
The traced contract, which the reference's fused executor runs inside
its jitted scan (``roundtrip_traced``, ``roundtrip_traced_stacked``; the
port's fused chunk runs the host boundary, whose payloads read nothing
from the device), hands back only the
decoded vector and the state as tensors: () for a stateless codec, the
residual for error feedback, (reference, inner state) for the delta
codec; ``init_state(s)_traced`` and ``state(s)_to_host`` convert, a host
None being a traced state of zeros.  Both contracts run
``encode_decode_traced(_stacked)``, which returns the wire buffers beside
the decoded vector, so they agree bit for bit by construction: the
error-feedback residual comes from the same dequantize launch on both
(``fma(-code, scale, adj)``), and the delta reconstruction is ``ref +
dec_delta`` on both.  The reference brackets its traced transform with
``jax.lax.optimization_barrier`` as a marker of the wire; PyTorch has no
counterpart (eager ops are never fused across it), so the port has none.
Bytes of a payload that is never built come from ``nbytes_static``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
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

    @property
    def nbytes_entropy(self) -> int:
        """The size under an ideal entropy coder, worked out on the host
        once the payload exists: the discrete code buffers at their
        empirical zeroth-order entropy (int4 as nibble symbols, top-k's
        sorted indices as gaps), the f32 side buffers (scales, kept
        values) at their raw size.  A payload of f32 buffers alone
        reports ``nbytes``."""
        bits = self.meta.get("bits")
        if bits in (4, 8):
            codes = self.arrays["codes"].detach().cpu().numpy()
            if bits == 4:                 # nibble symbols, not packed bytes
                u = codes.astype(np.uint8)
                codes = np.concatenate([u >> 4, u & 0xF], axis=None)
            code_bytes = -(-_entropy_total_bits(codes) // 8)
            scales = self.arrays["scales"]
            return int(code_bytes + scales.numel() * scales.element_size())
        if "indices" in self.arrays:      # topk: gap-coded sorted indices
            idx = self.arrays["indices"].detach().cpu().numpy() \
                .astype(np.int64)
            gaps = np.diff(idx, prepend=0)
            idx_bytes = -(-_entropy_total_bits(gaps) // 8)
            vals = self.arrays["values"]
            return int(idx_bytes + vals.numel() * vals.element_size())
        return self.nbytes


def _entropy_total_bits(symbols) -> int:
    """Total bits of a symbol array under its empirical distribution."""
    _, counts = np.unique(np.asarray(symbols).ravel(), return_counts=True)
    p = counts / counts.sum()
    return int(np.ceil(float(-(p * np.log2(p)).sum()) * counts.sum()))


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


def _rows(c: int, keys=None, bits=None):
    """Per-row keys and injected draws of a C-row call (None when absent)."""
    keys = list(keys) if keys is not None else [None] * c
    return keys, [None if bits is None else bits[i] for i in range(c)]


class Codec:
    """Base codec: subclasses implement the flat-vector transform."""

    name = "codec"
    # every codec runs the traced contract; the planner's
    # ``resolve_fused`` reads this
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
        alone), so the fused executor counts bytes without a payload."""
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
        decoded tree), through ``roundtrip_flat``."""
        flat, spec = tree_to_flat(tree)
        payload, new_state, decoded = self.roundtrip_flat(
            flat, spec, state, key=key, bits=bits)
        return payload, new_state, flat_to_tree(decoded, spec)

    # -- flat and stacked API (the host boundary) ------------------------
    def roundtrip_flat(self, flat, spec: TreeSpec, state=None, *, key=None,
                       bits=None):
        """One client's (d,) row: (payload, new_state, decoded (d,))."""
        d = int(flat.numel())
        arrays, decoded = self.encode_decode_traced(flat, key=key, bits=bits)
        return self.payload_from_arrays(arrays, spec, d), state, decoded

    def roundtrip_stacked(self, flats, spec: TreeSpec, states=None, *,
                          keys=None, bits=None):
        """``roundtrip_flat`` over the C rows of (C, d) ``flats``:
        (payloads, new_states, decoded (C, d)).  ``keys`` holds one
        generator (or None) per row; ``bits`` the rows' injected draws,
        stacked.  The quantize and top-k codecs make one batched pass over
        all rows (``encode_decode_traced_stacked``)."""
        c, d = flats.shape
        arrays, decoded = self.encode_decode_traced_stacked(
            flats, keys=keys, bits=bits)
        return (self.stacked_payloads_from_arrays(arrays, c, spec, d),
                list(states) if states is not None else [None] * c, decoded)

    def payload_from_arrays(self, arrays, spec, d: int) -> Payload:
        """One client's Payload from ``encode_decode_traced``'s buffers."""
        return Payload(self.name, dict(arrays),
                       {**self.meta_static(d), "spec": spec, "d": d})

    def stacked_payloads_from_arrays(self, arrays, c: int, spec: TreeSpec,
                                     d: int):
        """Per-client Payloads from ``encode_decode_traced_stacked``'s
        buffers (a leading (C,) axis; the quantize codec overrides it to
        slice its concatenated rows)."""
        return [self.payload_from_arrays({k: v[i] for k, v in
                                          arrays.items()}, spec, d)
                for i in range(c)]

    # -- traced contract (the fused executor) ------------------------------
    def init_state_traced(self, d: int, host_state=None, *, device=None):
        """The traced state of one stream (the downlink) from its host
        state."""
        return ()

    def state_to_host(self, state):
        """Inverse of ``init_state_traced``."""
        return None

    def init_states_traced(self, d: int, host_states, *, device=None):
        """The stacked traced state of C client streams (the uplink)."""
        return ()

    def states_to_host(self, states, n: int):
        return [None] * n

    def roundtrip_traced(self, flat, state=(), *, key=None, bits=None):
        """Encode and decode one (d,) vector without a Payload: (decoded,
        new_state)."""
        return self._roundtrip_traced_raw(flat, state, key=key, bits=bits)

    def _roundtrip_traced_raw(self, flat, state, *, key=None, bits=None):
        _, decoded = self.encode_decode_traced(flat, key=key, bits=bits)
        return decoded, state

    def encode_decode_traced(self, flat, *, key=None, bits=None):
        """(wire buffers, decoded (d,)) of one vector: the one transform
        both contracts run.  The base runs the flat-vector transform."""
        d = int(flat.numel())
        arrays, _ = self.encode_flat(flat, key=key, bits=bits)
        payload = self.payload_from_arrays(arrays, None, d)
        return arrays, self.decode_flat(payload)[:d]

    def roundtrip_traced_stacked(self, flats, states=(), *, keys=None,
                                 bits=None):
        """``roundtrip_traced`` over the C rows of (C, d) ``flats``: row c
        is ``roundtrip_traced(flats[c], key=keys[c])``."""
        _, decoded = self.encode_decode_traced_stacked(flats, keys=keys,
                                                       bits=bits)
        return decoded, states

    def encode_decode_traced_stacked(self, flats, *, keys=None, bits=None):
        """(wire buffers with a leading (C,) axis, decoded (C, d)).  The
        base runs the rows one by one (the reference vmaps them)."""
        keys, row_bits = _rows(flats.shape[0], keys, bits)
        out = [self.encode_decode_traced(f, key=k, bits=b)
               for f, k, b in zip(flats, keys, row_bits)]
        return ({name: torch.stack([a[name] for a, _ in out])
                 for name in out[0][0]},
                torch.stack([dec for _, dec in out]))

    def encode_decode_residual_traced_stacked(self, adj, *, keys=None,
                                              bits=None):
        """``encode_decode_traced_stacked`` of (C, d) ``adj`` plus the
        error-feedback residual ``adj - decoded``: (buffers, decoded,
        residual), as ``ErrorFeedback`` needs it.  The quantize codec
        overrides it to write the residual in its dequantize launch."""
        arrays, decoded = self.encode_decode_traced_stacked(adj, keys=keys,
                                                            bits=bits)
        return arrays, decoded, adj - decoded


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


def _zeros_or(state, d: int, device) -> torch.Tensor:
    """A host residual or reference (None: zeros) as an f32 tensor."""
    if state is None:
        return torch.zeros((d,), dtype=torch.float32,
                           device=device_lib.resolve(device))
    return state.float()


class ErrorFeedback(Codec):
    """Client-local residual around a lossy codec (the standard EF trick).

    The state is the client's residual flat vector (host: None = zeros;
    traced: the (d,) or stacked (C, d) tensor).  The client encodes ``adj
    = flat + residual`` through the inner codec and keeps ``adj -
    decoded`` as its next residual; the server only ever decodes.  The
    inner codec computes the residual with its roundtrip
    (``Codec.encode_decode_residual_traced_stacked``): the quantize codec
    in its dequantize launch, as one fused multiply-subtract, which is how
    XLA computes the reference's residual (see
    ``kernels.ref.dequantize_residual``); every other codec as the
    difference, exact for top-k (kept entries give 0, dropped ones
    ``adj``).  A row whose key is None rounds to nearest, as the
    reference's per-row fallback does.  Both contracts run ``_ef``.
    """

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name + "+ef"

    def _ef(self, flats, residuals, *, keys=None, bits=None):
        """(buffers, decoded (C, d), new residuals (C, d)) of (C, d)
        ``flats`` and their (C, d) residuals."""
        return self.inner.encode_decode_residual_traced_stacked(
            flats + residuals, keys=keys, bits=bits)

    def encode(self, tree, state=None, *, key=None, bits=None):
        payload, residual, _ = self.roundtrip(tree, state, key=key,
                                              bits=bits)
        return payload, residual

    def roundtrip_flat(self, flat, spec, state=None, *, key=None, bits=None):
        payloads, states, decoded = self.roundtrip_stacked(
            flat[None], spec, [state], keys=[key],
            bits=None if bits is None else bits[None])
        return payloads[0], states[0], decoded[0]

    def roundtrip_stacked(self, flats, spec, states=None, *, keys=None,
                          bits=None):
        c, d = flats.shape
        residuals = self.init_states_traced(
            d, states if states is not None else [None] * c,
            device=flats.device)
        arrays, decoded, residual = self._ef(flats, residuals, keys=keys,
                                             bits=bits)
        return (self.inner.stacked_payloads_from_arrays(arrays, c, spec, d),
                self.states_to_host(residual, c), decoded)

    # -- traced contract: the residual is the state ----------------------
    def init_state_traced(self, d: int, host_state=None, *, device=None):
        return _zeros_or(host_state, d, device)

    def state_to_host(self, state):
        return state

    def init_states_traced(self, d: int, host_states, *, device=None):
        return torch.stack([_zeros_or(s, d, device) for s in host_states])

    def states_to_host(self, states, n: int):
        return [states[i] for i in range(n)]

    def roundtrip_traced(self, flat, state, *, key=None, bits=None):
        decoded, residual = self.roundtrip_traced_stacked(
            flat[None], state[None], keys=[key],
            bits=None if bits is None else bits[None])
        return decoded[0], residual[0]

    def roundtrip_traced_stacked(self, flats, states, *, keys=None,
                                 bits=None):
        _, decoded, residual = self._ef(flats, states, keys=keys, bits=bits)
        return decoded, residual

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
    first transmission (no reference yet: a reference of zeros) carries
    the full parameters.  The state is (reference flat vector, inner codec
    state).  Decoding needs the receiver's reference, so only the
    ``roundtrip*`` API works; a bare ``decode`` raises.  The subtraction
    and the addition are one f32 rounding each on both contracts, as the
    reference's eager ones are.
    """

    def __init__(self, inner):
        self.inner = inner
        self.name = "delta+" + inner.name

    def roundtrip_flat(self, flat, spec, state=None, *, key=None, bits=None):
        ref, inner_state = (None, None) if state is None else state
        ref = _zeros_or(ref, int(flat.numel()), flat.device)
        payload, inner_state, dec_delta = self.inner.roundtrip_flat(
            flat - ref, spec, inner_state, key=key, bits=bits)
        decoded = ref + dec_delta
        return payload, (decoded, inner_state), decoded

    def roundtrip_stacked(self, flats, spec, states=None, *, keys=None,
                          bits=None):
        """Row by row: each row's reference is its own."""
        c = flats.shape[0]
        states = list(states) if states is not None else [None] * c
        keys, row_bits = _rows(c, keys, bits)
        out = [self.roundtrip_flat(f, spec, s, key=k, bits=b)
               for f, s, k, b in zip(flats, states, keys, row_bits)]
        return ([p for p, _, _ in out], [s for _, s, _ in out],
                torch.stack([dec for _, _, dec in out]))

    def encode(self, tree, state=None, *, key=None, bits=None):
        payload, new_state, _ = self.roundtrip(tree, state, key=key,
                                               bits=bits)
        return payload, new_state

    def decode_flat(self, payload):
        # Codec.decode calls this, so a bare decode raises too
        raise NotImplementedError(
            "delta codec reconstruction needs the receiver's reference; "
            "use roundtrip/roundtrip_flat")

    # -- traced contract: (reference, inner state) ---------------------------
    def init_state_traced(self, d: int, host_state=None, *, device=None):
        ref, inner = (None, None) if host_state is None else host_state
        return (_zeros_or(ref, d, device),
                self.inner.init_state_traced(d, inner, device=device))

    def state_to_host(self, state):
        ref, inner = state
        return (ref, self.inner.state_to_host(inner))

    def init_states_traced(self, d: int, host_states, *, device=None):
        pairs = [(None, None) if s is None else s for s in host_states]
        return (torch.stack([_zeros_or(r, d, device) for r, _ in pairs]),
                self.inner.init_states_traced(d, [i for _, i in pairs],
                                              device=device))

    def states_to_host(self, states, n: int):
        refs, inner = states
        inner_host = self.inner.states_to_host(inner, n)
        return [(refs[i], inner_host[i]) for i in range(n)]

    def roundtrip_traced(self, flat, state, *, key=None, bits=None):
        ref, inner_state = state
        dec_delta, inner_state = self.inner.roundtrip_traced(
            flat - ref, inner_state, key=key, bits=bits)
        decoded = ref + dec_delta
        return decoded, (decoded, inner_state)

    def roundtrip_traced_stacked(self, flats, states, *, keys=None,
                                 bits=None):
        refs, inner_states = states
        dec_delta, inner_states = self.inner.roundtrip_traced_stacked(
            flats - refs, inner_states, keys=keys, bits=bits)
        decoded = refs + dec_delta
        return decoded, (decoded, inner_states)

    def bits_per_param(self, d: int) -> float:
        return self.inner.bits_per_param(d)

    def nbytes_static(self, d: int) -> int:
        return self.inner.nbytes_static(d)

    def meta_static(self, d: int):
        return self.inner.meta_static(d)
