"""Codec spec strings (counterpart of ``repro.comms.registry``).

Spec grammar, as the reference's:  <name>[:<arg>][+ef]

    identity            raw f32 (32 bits a parameter)
    int8[:det]          blockwise stochastic int8 (~8.03 bits a parameter)
    int4[:det]          nibble-packed stochastic int4 (~4.03)
    ...+ef              wrapped in client-local error feedback

``:det`` rounds to nearest instead of stochastically.  The reference's
``topk``, ``lowrank`` and ``delta+`` specs are not ported yet: they raise,
as does any name the reference does not know either.
"""
from __future__ import annotations

from repro_torch.comms.codec import Codec, ErrorFeedback, IdentityCodec
from repro_torch.comms.quantize import QuantizeCodec

_FACTORIES = {
    "identity": lambda arg: IdentityCodec(),
    "int8": lambda arg: QuantizeCodec(bits=8, stochastic=(arg != "det")),
    "int4": lambda arg: QuantizeCodec(bits=4, stochastic=(arg != "det")),
}
# in the reference's registry, not in the port's yet
_NOT_PORTED = ("topk", "lowrank", "delta")


def available() -> tuple:
    return tuple(sorted(_FACTORIES))


def make_codec(spec: str) -> Codec:
    """'int8+ef' -> ErrorFeedback(QuantizeCodec(8))."""
    full = (spec or "identity").strip()
    wrap_ef = full.endswith("+ef")
    body = full[:-3] if wrap_ef else full
    name, _, arg = body.partition(":")
    if name.split("+")[0] in _NOT_PORTED:
        raise ValueError(f"codec spec {full!r}: {name.split('+')[0]!r} is "
                         f"not ported yet; ported: {available()}")
    if name not in _FACTORIES:
        raise ValueError(f"unknown codec {name!r}; available: {available()}")
    codec = _FACTORIES[name](arg)
    if wrap_ef:
        if isinstance(codec, IdentityCodec):
            raise ValueError("identity codec is lossless; +ef is a no-op "
                             "and almost certainly a config mistake")
        codec = ErrorFeedback(codec)
    return codec
