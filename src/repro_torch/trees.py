"""Nested dicts of tensors as trees, walked as ``jax.tree_util`` walks them.

Dict keys are visited in sorted order, so a flattened tree lays its leaves
out as JAX does (``wk, wo, wq, wv``, not the insertion order ``wq, wk, wv,
wo``): the flat rows of the Gram matrix and of the uplink match the
reference element for element.  ``None`` marks an empty slot (the
placeholders of ``split_trainable``) and is no leaf.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return None if tree is None else fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order; None slots are skipped."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_size(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))
