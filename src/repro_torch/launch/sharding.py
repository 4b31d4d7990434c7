"""Partition specs for params, optimizer state, batches and caches, and
their DTensor placements.

Counterpart of ``repro.launch.sharding``, rule for rule.  Megatron-style
tensor parallelism on the 'model' axis: column-parallel input projections
(wq/wk/wv/gate/up/in_proj), row-parallel output projections
(wo/down/out_proj), vocab-sharded embedding/lm_head, expert-parallel MoE
stacks (falling back to d_ff tensor parallelism when n_experts doesn't
divide the axis).  Batch dims ride the 'data' axis.  Every rule is guarded
by divisibility: dims that don't divide the mesh axis are replicated.

A spec is a tuple with one entry a tensor dim: None, an axis name, or a
tuple of names (major to minor, as a JAX ``PartitionSpec``).
``placements(spec, mesh)`` turns it into DTensor placements: ``Shard(d)``
on each mesh dim that tensor dim d names, ``Replicate()`` elsewhere.
DTensor shards over mesh dims in order, so a compound entry splits as
JAX's does.  A ``Sharding`` pairs a mesh with a spec, as a
``NamedSharding``.  ``mesh`` is a ``DeviceMesh`` or a
``mesh.AbstractMesh``: the rules read only its axis names and sizes.

Trees are walked as ``jax.tree_util`` walks the reference's (dict keys in
sorted order, ``NamedTuple`` fields, sequence indices), and a leaf's path
names are the dict keys, field names and indices on the way to it, as
the reference's ``_path_names`` reads JAX key paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ModelConfig

# projection-name classes (the dict key *above* the 'w' leaf)
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_if", "w_o",
        "router", "w", "r"}          # output-dim sharded
_ROW = {"wo", "w_down", "out_proj"}  # input-dim sharded


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec: the port's ``NamedSharding`` (a leaf of the
    trees below)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        """The local shape of a tensor of ``shape`` under this sharding."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for name in _names(entry):
                out[d] //= _axis_size(self.mesh, name)
        return tuple(out)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if name in _names(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def _div(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


# ------------------------------------------------------------------ trees
def tree_map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, NamedTuples,
    lists and tuples; ``path`` is the tuple of names on the way (str dict
    keys, field names, str indices).  None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(
            fn, getattr(tree, f), *(getattr(r, f) for r in rest),
            path=path + (f,)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, *(r[i] for r in rest),
                                             path=path + (str(i),))
                          for i, t in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


# ----------------------------------------------------------------- params
def param_spec(names, leaf, mesh, *, extra_leading: int = 0) -> tuple:
    """Spec of one parameter leaf at path ``names``.

    extra_leading: number of leading axes prepended outside the model
    (e.g. a client/pod stacking axis handled by the caller).
    """
    names = list(names)
    msize = _axis_size(mesh, "model")
    nd = leaf.ndim - extra_leading
    stacked = "slots" in names                 # period-stacked leading axis
    base = 1 if stacked else 0                 # first real weight dim
    spec = [None] * leaf.ndim

    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""

    def setax(dim, axis="model"):
        if _div(leaf.shape[extra_leading + dim], _axis_size(mesh, axis)):
            spec[extra_leading + dim] = axis

    if name in ("lora_A", "lora_B"):
        pass                                    # adapters replicated (tiny)
    elif name == "embed":
        setax(0)                                # vocab-sharded
    elif parent == "lm_head":
        setax(nd - 1)
    elif parent == "experts" or (len(names) >= 3 and names[-3] == "experts"):
        # stacked expert weights: (stack?, E, d, f). Prefer expert parallel.
        e_dim = base
        if _div(leaf.shape[extra_leading + e_dim], msize):
            spec[extra_leading + e_dim] = "model"
        else:                                   # fall back: shard d_ff
            ff_dim = nd - 1 if name in ("w_gate", "w_up") else nd - 2
            setax(ff_dim)
    elif name == "w" and parent in _COL:
        setax(nd - 1)
    elif name == "w" and parent in _ROW:
        setax(base)
    elif name in ("conv_w", "conv_b"):
        setax(nd - 1)
    # norms / gates / scalars / A_log / D / dt_bias / critic stay replicated
    return tuple(spec)


def param_shardings(tree, mesh, *, extra_leading: int = 0,
                    leading_axis: Optional[str] = None,
                    tensor_parallel: bool = True):
    """``Sharding`` tree for a param tree (None leaves pass through)."""
    def one(path, leaf):
        if not tensor_parallel:
            spec = (None,) * leaf.ndim
        else:
            spec = param_spec(path, leaf, mesh, extra_leading=extra_leading)
        if leading_axis is not None:
            parts = list(spec) + [None] * (leaf.ndim - len(spec))
            parts[0] = leading_axis
            spec = tuple(parts)
        return Sharding(mesh, spec)

    return tree_map_with_path(one, tree)


def _viewed_heads(cfg: ModelConfig, names) -> int:
    """The head count by which the model views the output of the
    projection at ``names`` (its first factor), 0 for any other leaf."""
    if len(names) < 2 or names[-1] != "w":
        return 0
    if names[-2] in ("wq", "wk", "wv"):
        # attention's q, k, v, the decode step grouped by the KV heads;
        # the mLSTM's q, k, v (H = Hkv)
        return cfg.n_kv_heads
    if names[-2] == "w":
        # the sLSTM's input projection, whose gate pre-activations meet
        # the per-head recurrent projection (H, d/H) and its regrouping
        return cfg.n_heads
    return 0


def head_split_shardings(cfg: ModelConfig, shardings):
    """``shardings`` with the projections that the model views per head
    replicated on 'model' where the heads do not divide by their 'model'
    shards.

    The model views a projection's output (..., H * Dh) as (..., H, Dh):
    attention's wq/wk/wv (the decode step groups the query heads by the
    KV heads, (Hkv, G)), the mLSTM's wq/wk/wv, and the sLSTM's input
    projection ``w``, whose gates feed a state that the recurrent
    projection views as (H, d / H).  DTensor takes such a view of a
    tensor sharded on the split dim only when its first factor divides by
    the shards; GSPMD, which the reference runs, reshards instead.  So
    where the heads do not divide (llama-3.2-1b: 8 KV heads over 16
    cards; xlstm-125m: 4 heads) the port's programs run these
    projections whole on every card of the axis, which costs their FLOPs
    that many times and no collective.  The reference's specs
    (``param_spec``) stay as they are.
    """
    def one(names, s):
        heads = _viewed_heads(cfg, names)
        if not heads:
            return s
        out = list(s.spec)
        entry = _names(out[-1])
        if "model" not in entry or heads % _axes_size(s.mesh, entry) == 0:
            return s
        rest = tuple(n for n in entry if n != "model")
        out[-1] = (rest if len(rest) > 1 else rest[0]) if rest else None
        return Sharding(s.mesh, tuple(out))

    return tree_map_with_path(one, shardings)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def rep_tree(tree, mesh, leading_axis: Optional[str] = None):
    def one(leaf):
        if leading_axis is not None and getattr(leaf, "ndim", 0) >= 1:
            return Sharding(mesh, (leading_axis,) + (None,) * (leaf.ndim - 1))
        return replicated(mesh)
    return tree_map(one, tree)


# ------------------------------------------------------------------ batches
def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= _axis_size(mesh, a)
    return n


def batch_spec(shape_tuple, mesh, *, extra_leading_axes=(),
               data_axes=("data",)) -> tuple:
    """Shard dim0 (batch) on the data axes when divisible; else rep."""
    dsize = _axes_size(mesh, data_axes)
    lead = list(extra_leading_axes)
    rest = shape_tuple[len(lead):]
    d_ax = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    return tuple(lead + [(d_ax if _div(rest[0], dsize) else None)]
                 + [None] * (len(rest) - 1))


def batch_shardings(tree, mesh, *, extra_leading_axes=(),
                    data_axes=("data",)):
    return tree_map(
        lambda s: Sharding(mesh, batch_spec(
            tuple(s.shape), mesh, extra_leading_axes=extra_leading_axes,
            data_axes=data_axes)), tree)


# ------------------------------------------------------------------- caches
def cache_shardings(cfg: ModelConfig, cache_tree, mesh, batch: int,
                    data_axes=("data",)):
    """Decode-cache shardings: batch -> data axes, long KV seq -> 'model'
    (context-parallel decode); recurrent-state heads -> 'model'.

    When batch doesn't divide the data axes (long_500k has B=1), the KV
    sequence is sharded over ALL axes instead.
    """
    dsize = _axes_size(mesh, data_axes)
    msize = _axis_size(mesh, "model")
    b_ok = _div(batch, dsize)
    d_ax = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    all_ax = tuple(data_axes) + ("model",)

    def one(names, leaf):
        name = names[-1]
        spec = [None] * leaf.ndim
        stacked = "slots" in names
        off = 1 if stacked else 0               # skip the periods axis
        if name in ("k", "v", "ck", "cv"):      # (P, B, C, Hkv, Dh)
            c = leaf.shape[off + 1]
            if b_ok:
                spec[off] = d_ax
                if _div(c, msize):
                    spec[off + 1] = "model"
            else:
                if _div(c, dsize * msize):
                    spec[off + 1] = all_ax
                elif _div(c, msize):
                    spec[off + 1] = "model"
        elif name == "conv":                    # (P, B, K, C)
            if b_ok:
                spec[off] = d_ax
        elif name == "state":                   # (P, B, nh, hd, ds)
            if b_ok:
                spec[off] = d_ax
            if _div(leaf.shape[off + 1], msize):
                spec[off + 1] = "model"
        elif name == "C":                       # (P, B, H, Dh, Dh)
            if b_ok:
                spec[off] = d_ax
            if _div(leaf.shape[off + 1], msize):
                spec[off + 1] = "model"
        elif name in ("n", "m", "c", "h"):      # (P, B, ...) states
            if b_ok:
                spec[off] = d_ax
        # 'pos' scalar: replicated
        return Sharding(mesh, tuple(spec))

    return tree_map_with_path(one, cache_tree)


# -------------------------------------------------------------- placement
def place(tree, shardings):
    """Each tensor of ``tree`` as a DTensor laid out by its ``Sharding``
    (a DeviceMesh's).  A ``meta`` tensor is split where it lies (its local
    shard is the slice this rank holds, no collective); any other is
    scattered from rank 0, as ``distribute_tensor`` does."""
    def one(t, s):
        return distribute_tensor(
            t, s.mesh, s.placements,
            src_data_rank=None if t.device.type == "meta" else 0)
    return tree_map(one, tree, shardings)
