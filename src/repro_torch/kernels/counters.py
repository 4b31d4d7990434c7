"""The kernels' launch counters, as one table.

Each wrapper adds one to a plain integer on its module where it launches
its kernel, and nowhere else.  A captured CUDA graph runs no Python when it
is replayed, so the code that replays one moves the counters for it:
``read`` before a capture and ``since`` after it give one replay's
launches; ``add(counts, -1)`` takes back the capture's (the capture
launched nothing), and ``add(counts)`` after every replay adds a replay's.
``chip_smoke.py`` zeroes and reads them around the main path.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention, gram, quantize, rmsnorm, ssd

# name -> (module, attribute) of every launch counter
COUNTERS = {"rmsnorm": (rmsnorm, "launches"),
            "rmsnorm_bwd": (rmsnorm, "bwd_launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches"),
            "gram": (gram, "launches"),
            "quantize": (quantize, "quantize_launches"),
            "dequantize": (quantize, "dequantize_launches"),
            "abs_threshold_count": (quantize, "threshold_count_launches"),
            "abs_threshold_mask": (quantize, "threshold_mask_launches"),
            "ssd": (ssd, "launches"),
            "ssd_bwd": (ssd, "bwd_launches")}


def read() -> dict:
    """Every counter's value, by name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def zero() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def since(before: dict) -> dict:
    """The counters that moved since ``read()`` gave ``before``, by how
    much."""
    now = read()
    return {name: now[name] - before[name] for name in now
            if now[name] != before[name]}


def add(counts: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (name -> launches) to the counters."""
    for name, n in counts.items():
        mod, attr = COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + sign * n)
