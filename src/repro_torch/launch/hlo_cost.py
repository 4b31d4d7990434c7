"""A per-device cost counter: flops, bytes and collective bytes of a
function, counted at dispatch.

Counterpart of ``repro.launch.hlo_cost``, which walks compiled HLO text.
The port has no HLO: ``analyze(fn, *args)`` runs the function under
``CostCounter``, a ``TorchDispatchMode``, and counts each operation this
device runs, with the reference's conventions:

  flops  : a matmul (mm, addmm, bmm, baddbmm; einsum and linear reach
           these) = 2 * prod(result dims) * prod(contracted dims), plus
           prod(result) for the bias of addmm/baddbmm; a reduction =
           the elements it reads; other arithmetic = prod(result dims);
           views, copies, gathers, concatenations, compares, selects
           and factories none
  bytes  : operands + results of every operation but the views and the
           allocations; an in-place update (index_copy_, index_put_,
           copy_ into a slice, slice_scatter) counts twice its update,
           not the buffer it writes into
  coll   : operand bytes of all-reduce / all-gather / reduce-scatter /
           all-to-all / broadcast, by kind, and by the mesh dims of the
           group it runs over

A kernel call counts once, with the card kernel's costs
(``kernels.costs``): on the card the wrapper charges it beside its launch
counter, and a plain version (on the CPU or on ``meta`` tensors) is
charged as one call whose own operations are left out.

Per device: a DTensor operation is not counted at the DTensor level,
whose shapes are global; the counter lets DTensor run it and counts what
reaches the local shards (the redistributions' collectives and the local
operation).  DTensor's sharding propagation runs operations on fake
tensors to learn their shapes: those are not counted.  Python loops run
their bodies as often as they turn, so a loop of 10 counts 10 times.

``peak_bytes`` is the peak over the run of the bytes held by the tensors
that operations allocated (kernel outputs included), counted until each
is freed: the port's ``temp_size``.
"""
from __future__ import annotations

import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")
# collective op name (``_c10d_functional`` and ``c10d``) -> kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}  # -> first factor
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "prod", "var", "std", "var_mean", "std_mean",
               "linalg_vector_norm", "norm", "logsumexp", "any", "all",
               "cumsum", "cumprod"}
# operations that move or make data and compute nothing (bytes only)
_NO_FLOPS = {"_to_copy", "clone", "copy", "copy_", "cat", "stack",
             "index_select", "gather", "scatter", "scatter_", "index_copy",
             "index_copy_", "index_put", "index_put_", "slice_scatter",
             "select_scatter", "embedding", "constant_pad_nd", "repeat",
             "repeat_interleave", "fill", "fill_", "zero_", "zeros",
             "zeros_like", "ones", "ones_like", "full", "full_like",
             "arange", "where", "masked_fill", "masked_fill_", "eq", "ne",
             "lt", "le", "gt", "ge", "logical_and", "logical_or",
             "logical_not", "bitwise_and", "bitwise_or", "bitwise_not",
             "sort", "topk", "tril", "triu", "flip", "roll", "one_hot",
             "_unsafe_index", "index", "lift_fresh_copy"}
# in-place updates of part of a buffer: twice the update, not the buffer
_UPDATES = {"copy_", "index_copy", "index_copy_", "index_put",
            "index_put_", "slice_scatter", "select_scatter", "scatter_",
            "index_add_"}
# allocations, host reads and bookkeeping: nothing
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense", "detach", "alias",
         "_unsafe_view", "lift_fresh", "wait_tensor",
         "_wrap_tensor_autograd", "set_", "resize_", "record_stream"}


_FAKE = torch._C._TorchDispatchModeKey.FAKE


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


class CostCounter(TorchDispatchMode):
    """Counts this device's flops, bytes and collectives while open (see
    the module docstring).  ``mesh`` names the mesh dims of the groups its
    collectives run over, and ``groups`` (name -> process group) names
    more, or overrides them (one card's world-1 group as 'pod'); any other
    group is 'world' (the default group) or 'group <name>'."""

    def __init__(self, mesh=None, groups=None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.collectives_by_dim = {}  # mesh dims -> kind -> count, bytes
        self.kernels = {}             # name -> calls charged
        self.flops_by_op = {}         # op or kernel name -> flops
        self.paused = 0               # > 0 inside a kernel call
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}               # storage key -> [bytes, refs]
        self._dims = {}               # group name -> mesh dims
        if mesh is not None:
            for name in mesh.mesh_dim_names:
                self._dims[mesh.get_group(name).group_name] = name
        for name, group in (groups or {}).items():
            self._dims[group.group_name] = name

    # ------------------------------------------------------------ kernels
    def charge_kernel(self, name: str, n_bytes: int, ops: int, peak: str):
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self.flops += ops
        self.flops_by_op[name] = self.flops_by_op.get(name, 0) + ops
        self.bytes += n_bytes

    def track_made(self, tensors) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                # the DTensor's own local tensor, whose life the DTensor's
                # is (``to_local()`` may return a new view)
                self._track(getattr(t, "_local_tensor", t))

    # ------------------------------------------------------------- memory
    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    # ------------------------------------------------------------ counting
    def _group_dims(self, args) -> str:
        """The mesh dims (or 'world', or 'group <name>') of the group a
        collective's arguments name: a group name or a process group."""
        names = [a if isinstance(a, str) else a.group_name for a in args
                 if isinstance(a, str) and a.isdigit()
                 or hasattr(a, "group_name")]
        for name in names:
            if name in self._dims:
                return self._dims[name]
        if not names or names[0] == dist.group.WORLD.group_name:
            return "world"
        return f"group {names[0]}"

    def _collective(self, kind: str, args, kwargs) -> None:
        n = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        dim = self._group_dims(list(args) + list(kwargs.values()))
        by_dim = self.collectives_by_dim.setdefault(dim, {}).setdefault(
            kind, {"count": 0, "bytes": 0})
        for rec in (self.collectives[kind], by_dim):
            rec["count"] += 1
            rec["bytes"] += n

    def _op(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        if name in _FREE:
            return
        schema = func._schema
        rets = schema.returns
        if rets and all(r.alias_info is not None
                        and not r.alias_info.is_write for r in rets):
            return                                   # a view
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in _UPDATES:
            self.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
            return
        self.bytes += sum(_nbytes(t) for t in ins)
        if not any(r.alias_info is not None for r in rets):
            self.bytes += sum(_nbytes(t) for t in outs)
        elif outs:
            self.bytes += _nbytes(outs[0])           # written in place
        flops = 0
        if name in _MATMULS:
            res = outs[0].numel()
            flops = 2 * res * args[_MATMULS[name]].shape[-1]
            if _MATMULS[name]:
                flops += res
        elif name in _REDUCTIONS:
            flops = ins[0].numel() if ins else 0
        elif name not in _NO_FLOPS and outs:
            flops = outs[0].numel()
        if flops:
            self.flops += flops
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count its local operations
        if (torch._C._get_dispatch_mode(_FAKE) is not None
                or any(issubclass(t, FakeTensor) for t in types)):
            return func(*args, **kwargs)   # sharding propagation's shapes
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVE_OPS:
            self._collective(_COLLECTIVE_OPS[name], args, kwargs)
        elif not self.paused:
            self._op(func, args, kwargs, out)
            rets = func._schema.returns
            for t, r in zip(_tensors(out), rets):
                if r.alias_info is None:
                    self._track(t)
        return out

    def totals(self) -> dict:
        """The reference's keys, plus the collectives by mesh dim, the
        kernel calls charged and the peak of tracked bytes."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": float(sum(
                    c["bytes"] for c in self.collectives.values())),
                "collectives": {k: dict(v) for k, v
                                in self.collectives.items()},
                "collectives_by_dim": {d: {k: dict(v) for k, v in kinds.items()}
                                       for d, kinds
                                       in self.collectives_by_dim.items()},
                "collective_bytes_by_dim": {
                    d: sum(v["bytes"] for v in kinds.values())
                    for d, kinds in self.collectives_by_dim.items()},
                "kernels": dict(self.kernels),
                "flops_by_op": dict(sorted(self.flops_by_op.items(),
                                           key=lambda kv: -kv[1])),
                "peak_bytes": self.peak_bytes}


def analyze(fn, *args, mesh=None, groups=None, **kwargs) -> dict:
    """``CostCounter.totals()`` of one call ``fn(*args, **kwargs)``."""
    with CostCounter(mesh, groups) as counter:
        fn(*args, **kwargs)
    return counter.totals()
