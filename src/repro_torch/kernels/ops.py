"""Dispatch between the Hopper kernels and their plain versions.

Mirrors ``repro.kernels.ops`` with ``use_kernel`` in place of
``use_pallas``.  The choice follows the tensor's device: a CPU tensor goes
to the plain PyTorch version in ``kernels.ref`` (differentiated by
autograd); any other tensor goes to the kernel's wrapper, which launches
on a CUDA tensor and raises on anything else.  On CUDA ``rmsnorm`` and
``flash_attention`` are ``autograd.Function``s whose backward runs the
backward kernels.  ``use_kernel=False`` forces the plain version and
exists for the tests and for ``chip_smoke.py``'s comparisons; the model's
main path never passes it.
"""
from __future__ import annotations

import torch

from repro_torch import trees
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn


def _kernel(x: torch.Tensor, use_kernel: bool) -> bool:
    return use_kernel and x.device.type != "cpu"


def gram(x, *, use_kernel: bool = True):
    """(M, d) stacked flat gradients -> (M, M) f32 Gram matrix."""
    if _kernel(x, use_kernel):
        return _gram.gram(x)
    return ref.gram(x)


def gram_from_pytrees(grads, *, use_kernel: bool = True):
    """List of M gradient trees -> (M, M).

    Each tree's leaves, in sorted-key order as ``jax.tree_util`` walks
    them, are flattened to f32 and concatenated into one row of an (M, d)
    matrix, as ``repro.kernels.ops.gram_from_pytrees`` does.
    """
    rows = [torch.cat([leaf.float().reshape(-1)
                       for leaf in trees.tree_leaves(g)]) for g in grads]
    return gram(torch.stack(rows), use_kernel=use_kernel)


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


def quantize(x2, bits, qmax: int = 127, *, use_kernel: bool = True):
    """(R, 1024) f32 + int32 rounding-bit patterns -> (int8 codes, (R, 1)
    scales)."""
    if _kernel(x2, use_kernel):
        return _q.quantize(x2, bits, qmax)
    return ref.quantize(x2, bits, qmax)


def dequantize(codes, scales, *, use_kernel: bool = True):
    """(R, 1024) int8 codes, (R, 1) scales -> (R, 1024) f32."""
    if _kernel(codes, use_kernel):
        return _q.dequantize(codes, scales)[0]
    return ref.dequantize(codes, scales)


def dequantize_with_residual(codes, scales, adj, *, use_kernel: bool = True):
    """``dequantize`` plus the error-feedback residual ``adj - codes *
    scale`` rounded once, in one launch on CUDA: (decoded, residual)."""
    if _kernel(codes, use_kernel):
        return _q.dequantize(codes, scales, adj)
    return (ref.dequantize(codes, scales),
            ref.dequantize_residual(codes, scales, adj))
