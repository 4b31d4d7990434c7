"""Dispatch between the Hopper kernels and their plain versions.

Mirrors ``repro.kernels.ops`` with ``use_kernel`` in place of
``use_pallas``.  The choice follows the tensor's device: a CPU tensor goes
to the plain PyTorch version in ``kernels.ref``; any other tensor goes to
the kernel's wrapper, which launches on a CUDA tensor and raises on
anything else.  ``use_kernel=False`` forces the plain version and exists
for the tests and for ``chip_smoke.py``'s comparisons; the model's main
path never passes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn


def _kernel(x: torch.Tensor, use_kernel: bool) -> bool:
    return use_kernel and x.device.type != "cpu"


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    use_kernel: bool = True):
    if _kernel(q, use_kernel):
        return _fa.flash_attention(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    return ref.flash_attention(q, k, v, causal=causal,
                               sliding_window=sliding_window)


def rmsnorm(x, g, eps: float = 1e-5, *, use_kernel: bool = True):
    if _kernel(x, use_kernel):
        return _rn.rmsnorm(x, g, eps)
    return ref.rmsnorm(x, g, eps)
