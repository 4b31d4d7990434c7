"""Device policy of the port's entry points: ``cuda`` unless asked otherwise."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on; ``None`` means ``cuda``.

    Raises when CUDA is asked for and no card is present: the port never
    falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
