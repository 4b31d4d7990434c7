"""Carry parameter trees between the JAX package and the port.

The JAX side hands over its tree as nested dicts of **numpy** arrays
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX.  Layouts are kept as they are: a projection ``w`` stays
``(din, dout)`` and is applied as ``x @ w``, and the pattern slots stay
stacked over periods on the leading axis (``slots["0"][...]`` has shape
``(n_periods, ...)``).  Only the container type changes.

``np.asarray`` of a JAX bf16 array has dtype ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses; such leaves travel as their 16-bit patterns
(``view(np.uint16)`` then ``view(torch.bfloat16)``), so every leaf
arrives bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # the bfloat16 numpy dtype is registered by ml_dtypes, which the
        # JAX side has loaded; the port itself never imports it
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def to_torch(tree, device="cuda"):
    """Nested dicts (or lists/tuples) of numpy arrays -> same of tensors."""
    dev = device_lib.resolve(device)
    return _map(tree, lambda a: leaf_to_torch(a, dev))


def to_numpy(tree):
    """Nested dicts (or lists/tuples) of tensors -> same of numpy arrays."""
    return _map(tree, leaf_to_numpy)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)
