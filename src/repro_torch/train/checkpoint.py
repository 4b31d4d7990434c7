"""Tree checkpoints in ``.npz`` (counterpart of
``repro.train.checkpoint``, with the same file layout).

Leaves are stored under their '/'-joined key paths in sorted-key order;
``None`` slots are skipped; bf16 leaves are stored widened to f32 (npz has
no bf16) and take their dtype back from the reference tree on restore.  A
file written by either package restores in the other.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch import trees


def _paths(tree, prefix: str = ""):
    """(key path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif tree is not None:
        yield prefix[:-1], tree


def save(path: str, tree, step: Optional[int] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {key: leaf.detach().cpu().float().numpy()
            if leaf.dtype == torch.bfloat16 else leaf.detach().cpu().numpy()
            for key, leaf in _paths(tree)}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)


def restore(path: str, ref_tree):
    """Load into the structure, dtypes and devices of ``ref_tree`` (shapes
    must match); returns (tree, step or None)."""
    with np.load(path) as data:
        leaves = []
        for key, leaf in _paths(ref_tree):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(leaf.device, leaf.dtype))
        step = int(data["__step__"]) if "__step__" in data else None
    return trees.tree_unflatten(ref_tree, leaves), step
