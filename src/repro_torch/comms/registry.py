"""Codec spec strings (counterpart of ``repro.comms.registry``).

Spec grammar, as the reference's:  [delta+]<name>[:<arg>][+ef]

    identity            raw f32 (32 bits a parameter)
    int8[:det]          blockwise stochastic int8 (~8.03 bits a parameter)
    int4[:det]          nibble-packed stochastic int4 (~4.03)
    topk[:<frac>]       magnitude top-k, frac of the parameters kept
                        (64 * frac bits a parameter; frac 0.05 by default)
    lowrank[:<rank>]    PowerSGD-style rank-r sketch (rank 4 by default)
    ...+ef              wrapped in client-local error feedback
    delta+...           the delta against the last round's reconstruction
                        (a downlink codec); wraps the rest of the spec

``:det`` rounds to nearest instead of stochastically.  An unknown name
raises, and so does ``identity+ef``.  ``register(name)`` adds a user
codec: a decorator of a factory ``(arg: str) -> Codec``, after which the
name resolves as the built-ins do (``+ef`` and ``delta+`` included).
"""
from __future__ import annotations

from repro_torch.comms.codec import (Codec, DeltaCodec, ErrorFeedback,
                                     IdentityCodec)
from repro_torch.comms.lowrank import LowRankCodec
from repro_torch.comms.quantize import QuantizeCodec
from repro_torch.comms.sparsify import TopKCodec

_FACTORIES = {
    "identity": lambda arg: IdentityCodec(),
    "int8": lambda arg: QuantizeCodec(bits=8, stochastic=(arg != "det")),
    "int4": lambda arg: QuantizeCodec(bits=4, stochastic=(arg != "det")),
    "topk": lambda arg: TopKCodec(frac=float(arg or 0.05)),
    "lowrank": lambda arg: LowRankCodec(rank=int(arg or 4)),
}


def register(name: str):
    """Decorator: ``@register("mycodec")`` over a factory ``(arg: str) ->
    Codec`` makes ``"mycodec[:arg][+ef]"`` a codec spec."""
    def deco(factory):
        _FACTORIES[name] = factory
        return factory
    return deco


def available() -> tuple:
    return tuple(sorted(_FACTORIES))


def make_codec(spec: str) -> Codec:
    """'topk:0.05+ef' -> ErrorFeedback(TopKCodec(0.05))."""
    spec = (spec or "identity").strip()
    # delta wraps the rest of the spec ("delta+int8+ef" ->
    # DeltaCodec(ErrorFeedback(int8))): the inner codec sees the deltas
    if spec == "delta" or spec.startswith("delta+"):
        return DeltaCodec(make_codec(spec[len("delta+"):] or "identity"))
    wrap_ef = spec.endswith("+ef")
    if wrap_ef:
        spec = spec[:-3]
    name, _, arg = spec.partition(":")
    if name not in _FACTORIES:
        raise ValueError(f"unknown codec {name!r}; available: {available()}")
    codec = _FACTORIES[name](arg)
    if wrap_ef:
        if isinstance(codec, IdentityCodec):
            raise ValueError("identity codec is lossless; +ef is a no-op "
                             "and almost certainly a config mistake")
        codec = ErrorFeedback(codec)
    return codec
