"""The uplink/downlink codecs of the federated round (counterpart of
``repro.comms``): ``identity``, ``int8``/``int4``, ``topk``, ``lowrank``,
``+ef`` and ``delta+``, at the host boundary and in the traced contract
of the fused executor."""
from repro_torch.comms.codec import (Codec, DeltaCodec, ErrorFeedback,
                                     IdentityCodec, Payload, TreeSpec,
                                     flat_to_tree, tree_to_flat)
from repro_torch.comms.lowrank import LowRankCodec
from repro_torch.comms.quantize import QuantizeCodec
from repro_torch.comms.registry import available, make_codec
from repro_torch.comms.sparsify import TopKCodec

__all__ = ["Codec", "DeltaCodec", "ErrorFeedback", "IdentityCodec",
           "LowRankCodec", "Payload", "QuantizeCodec", "TopKCodec",
           "TreeSpec", "available", "make_codec", "tree_to_flat",
           "flat_to_tree"]
