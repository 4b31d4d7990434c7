"""Communication accounting (counterpart of ``repro.core.comms``: the
measured bytes and the ledger; the analytic byte models and the
scheduler's time models are not ported yet)."""
from __future__ import annotations

import dataclasses

from repro_torch import trees


def tree_param_bytes(tree) -> int:
    """Bytes of a raw (uncoded) tree: size times itemsize."""
    return sum(t.numel() * t.element_size() for t in trees.tree_leaves(tree))


def measured_bytes(obj) -> int:
    """Wire bytes of an encoded Payload or of a raw tree."""
    if hasattr(obj, "arrays") and hasattr(obj, "nbytes"):    # Payload
        return int(obj.nbytes)
    return tree_param_bytes(obj)


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
