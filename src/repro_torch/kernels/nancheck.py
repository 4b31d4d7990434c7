"""The kernels' NaN check.

A hand-written kernel's launch is no ATen op, so no dispatch mode sees its
outputs: each wrapper passes them to ``check_output`` after its launch.
The check is off unless ``enabled`` is set, which ``obs.debug.
set_debug_nan`` does; this module imports nothing of the package.
"""
from __future__ import annotations

import torch

# set by obs.debug.set_debug_nan
enabled = False


def has_nan(t) -> bool:
    """``t`` is a floating tensor that holds a NaN (reads it back)."""
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.device.type != "meta" and bool(torch.isnan(t).any()))


def check_output(kernel: str, *outs) -> None:
    """A kernel wrapper's check after its launch: raise if the check is on
    and an output (None: not made by this call) holds a NaN."""
    if enabled and any(has_nan(t) for t in outs):
        raise FloatingPointError(f"NaN in the output of kernel {kernel}")
