"""Communication accounting (counterpart of ``repro.core.comms``; paper
Fig. 1's O(Cd) against O(CMd)).

The measured bytes and the ledger: a raw tree costs size times itemsize
and an encoded Payload its ``nbytes``.  The analytic byte models of each
protocol, their codec-aware twins (from each codec's ``bits_per_param``)
and the scheduler's time-from-bytes models are plain Python and equal the
reference's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch import trees

BYTES_F32 = 4


def tree_param_bytes(tree) -> int:
    """Bytes of a raw (uncoded) tree: size times itemsize."""
    return sum(t.numel() * t.element_size() for t in trees.tree_leaves(tree))


def measured_bytes(obj) -> int:
    """Wire bytes of an encoded Payload or of a raw tree."""
    if hasattr(obj, "arrays") and hasattr(obj, "nbytes"):    # Payload
        return int(obj.nbytes)
    return tree_param_bytes(obj)


def firm_round_bytes(d_trainable: int, n_clients: int, local_steps: int = 1
                     ) -> Dict[str, int]:
    """FIRM (Alg. 1): broadcast theta down and C adapted params up, once a
    round whatever K or M."""
    up = n_clients * d_trainable * BYTES_F32
    down = n_clients * d_trainable * BYTES_F32
    return {"up": up, "down": down, "total": up + down}


def fedcmoo_round_bytes(d_trainable: int, n_clients: int, n_objectives: int,
                        local_steps: int = 1, compress_rank: int = 0
                        ) -> Dict[str, int]:
    """Server-centric: per local step M gradients up (or M sketches of
    size q) and lambda down; plus FedAvg's param sync each round."""
    per_grad = (compress_rank or d_trainable) * BYTES_F32
    up = n_clients * (n_objectives * per_grad * local_steps
                      + d_trainable * BYTES_F32)
    down = n_clients * (n_objectives * BYTES_F32 * local_steps
                        + d_trainable * BYTES_F32)
    return {"up": up, "down": down, "total": up + down}


def codec_bytes_per_param(spec: str, d_trainable: int) -> float:
    """Analytic wire bytes a param of a codec spec (``repro_torch.comms``)."""
    from repro_torch.comms import make_codec
    return make_codec(spec).bits_per_param(d_trainable) / 8.0


def firm_round_bytes_codec(d_trainable: int, n_clients: int,
                           uplink_codec: str = "identity",
                           downlink_codec: str = "identity",
                           local_steps: int = 1) -> Dict[str, int]:
    """A FIRM round with coded links: still O(Cd), scaled by the codecs'
    rates."""
    up_bpp = codec_bytes_per_param(uplink_codec, d_trainable)
    down_bpp = codec_bytes_per_param(downlink_codec, d_trainable)
    up = int(n_clients * d_trainable * up_bpp)
    down = int(n_clients * d_trainable * down_bpp)
    return {"up": up, "down": down, "total": up + down}


def fedcmoo_round_bytes_codec(d_trainable: int, n_clients: int,
                              n_objectives: int, local_steps: int = 1,
                              uplink_codec: str = "identity",
                              downlink_codec: str = "identity"
                              ) -> Dict[str, int]:
    """FedCMOO with coded links: the M K gradient uploads and the param
    sync ride the uplink codec; lambda's broadcasts stay f32 (O(M))."""
    up_bpp = codec_bytes_per_param(uplink_codec, d_trainable)
    down_bpp = codec_bytes_per_param(downlink_codec, d_trainable)
    up = int(n_clients * d_trainable * up_bpp
             * (n_objectives * local_steps + 1))
    down = int(n_clients * (n_objectives * BYTES_F32 * local_steps
                            + d_trainable * down_bpp))
    return {"up": up, "down": down, "total": up + down}


# ------------------------------------------------------- time-from-bytes
# The scheduler's simulated clock (``fed.sched``): a transmission's time
# comes from measured Payload bytes, so the codec moves simulated seconds
# as well as the ledger.

def transmission_seconds(nbytes: float, bytes_per_sec: float) -> float:
    """Wire time of a payload over a link of the given bandwidth."""
    return float(nbytes) / max(float(bytes_per_sec), 1e-9)


def compute_seconds(tokens: float, tokens_per_sec: float) -> float:
    """Local-phase compute time at a client's processing rate."""
    return float(tokens) / max(float(tokens_per_sec), 1e-9)


def local_phase_tokens(local_steps: int, batch_size: int,
                       seq_len: int) -> int:
    """Token work of one client's local phase: K steps of B sequences of
    (prompt + generated) tokens; generation and the update both scale
    linearly in it at a fixed model size."""
    return int(local_steps) * int(batch_size) * int(seq_len)


def client_round_segments(profile, down_nbytes: float, up_nbytes: float,
                          local_steps: int, batch_size: int,
                          seq_len: int):
    """One client round as ordered (phase, seconds) segments: download,
    local compute, upload.  The scheduler's round time is their sum; the
    trace renders each as a span, so the timeline adds up exactly."""
    toks = local_phase_tokens(local_steps, batch_size, seq_len)
    return (
        ("download", transmission_seconds(down_nbytes,
                                          profile.down_bytes_per_sec)),
        ("compute", compute_seconds(toks, profile.tokens_per_sec)),
        ("upload", transmission_seconds(up_nbytes,
                                        profile.up_bytes_per_sec)),
    )


@dataclasses.dataclass
class CommsLedger:
    up_bytes: int = 0
    down_bytes: int = 0
    rounds: int = 0

    def send_up(self, obj):
        """obj: encoded Payload or raw tree, measured either way."""
        self.up_bytes += measured_bytes(obj)

    def send_down(self, obj):
        self.down_bytes += measured_bytes(obj)

    def next_round(self):
        self.rounds += 1

    @property
    def total(self) -> int:
        return self.up_bytes + self.down_bytes
