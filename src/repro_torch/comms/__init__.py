"""The uplink/downlink codecs of the federated round (counterpart of
``repro.comms``), as far as the ``datacenter``, ``wan`` and ``mobile``
presets need them: ``identity``, ``int8``/``int4`` and ``+ef``."""
from repro_torch.comms.codec import (Codec, ErrorFeedback, IdentityCodec,
                                     Payload, TreeSpec, flat_to_tree,
                                     tree_to_flat)
from repro_torch.comms.quantize import QuantizeCodec
from repro_torch.comms.registry import available, make_codec

__all__ = ["Codec", "ErrorFeedback", "IdentityCodec", "Payload",
           "QuantizeCodec", "TreeSpec", "available", "make_codec",
           "tree_to_flat", "flat_to_tree"]
