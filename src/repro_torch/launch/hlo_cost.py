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
           not the buffer it writes into, and a slice at a tensor
           position (index_select, the reference's dynamic-slice) twice
           what it takes
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
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

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
# slices at a position given by a tensor (the reference's dynamic-slice):
# twice what they take, not the buffer they take it from
_SLICES = {"index_select"}
# allocations, host reads and bookkeeping: nothing
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense", "detach", "alias",
         "_unsafe_view", "lift_fresh", "wait_tensor",
         "_wrap_tensor_autograd", "set_", "resize_", "record_stream"}


_FAKE = torch._C._TorchDispatchModeKey.FAKE
_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format, slice, type(Ellipsis))


def _leaves(x, out: list) -> list:
    """The leaves of an operation's arguments (lists, tuples and dicts of
    them), in order: what ``torch.utils._pytree.tree_leaves`` gives for
    them, at a fraction of its cost (the counter walks every
    operation's)."""
    if isinstance(x, (list, tuple)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for k, y in x.items():
            out.append(k)
            _leaves(y, out)
    else:
        out.append(x)
    return out


def tree_leaves(tree) -> list:
    return _leaves(tree, [])


def _dtensor_key(func, args, kwargs):
    """The operation and its operands' specs and metadata (a DTensor's
    spec and its shard's metadata), or None where an operand is not on
    ``meta`` or cannot be named."""
    key = [func]
    for leaf in tree_leaves((args, kwargs)):
        if isinstance(leaf, DTensor):
            local = leaf._local_tensor
            if local.device.type != "meta":
                return None
            key.append((leaf._spec, tuple(local.shape), local.stride(),
                        local.dtype))
        elif isinstance(leaf, torch.Tensor):
            if type(leaf) is not torch.Tensor:
                return None
            key.append((tuple(leaf.shape), leaf.stride(), leaf.dtype,
                        leaf.device))
        elif isinstance(leaf, _SCALARS):
            key.append((type(leaf), leaf))
        else:
            return None
    return tuple(key)


# operations whose outputs' layouts and costs do not depend on the
# position they select (a recurrence's step t): the argument left out of
# their key
_POSITION_FREE = {torch.ops.aten.select.int: 2,
                  torch.ops.aten.select_backward.default: 3}
_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    """Whether ``func`` returns new tensors and writes none of its
    operands."""
    out = _FUNCTIONAL.get(func)
    if out is None:
        schema = func._schema
        out = _FUNCTIONAL[func] = (
            bool(schema.returns)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in schema.returns)
            and not any(a.alias_info is not None and a.alias_info.is_write
                        for a in schema.arguments))
    return out


_VIEWS: dict = {}


def _view(func) -> bool:
    """Whether ``func`` returns views of its operands and writes none."""
    out = _VIEWS.get(func)
    if out is None:
        schema = func._schema
        out = _VIEWS[func] = (
            bool(schema.returns)
            and all(r.alias_info is not None and not r.alias_info.is_write
                    and str(r.type) == "Tensor" for r in schema.returns)
            and not any(a.alias_info is not None and a.alias_info.is_write
                        for a in schema.arguments))
    return out




# what the plain branch does with an operation, by ``id(func)`` (an
# operation is one object for the life of the process, and its own hash
# is a Python call): run it alone (a view: neither counted nor tracked),
# record and replay it (functional), or run and count it (anything else,
# and an operation found to return an alias of an operand although its
# schema names none, as ``_unsafe_view``)
_RUN, _VIEW, _RECORD, _IN_PLACE = 0, 1, 2, 3
_KINDS: dict = {}
# element-wise updates of their first operand, which they return (the
# engine sums gradients with ``add_``): recorded as their counts alone
_IN_PLACE_NAMES = {"add_", "sub_", "mul_", "div_", "copy_", "masked_fill_"}


def _kind(func) -> int:
    kind = _KINDS.get(id(func))
    if kind is None:
        kind = _KINDS[id(func)] = (
            _RUN if func.namespace in ("_c10d_functional", "c10d")
            else _VIEW if _view(func) else _RECORD if _functional(func)
            else _IN_PLACE if func._schema.name.split("::")[-1]
            in _IN_PLACE_NAMES else _RUN)
    return kind


_PLAIN_SCALARS = frozenset(_SCALARS)


def _meta_key_of(x, key: list) -> int:
    """Append the metadata of ``x`` (an operand, or a list or tuple of
    them) to ``key``: the plain ``meta`` tensors it holds, or -1 where a
    tensor is not one or an operand cannot be named."""
    t = type(x)
    if t is torch.Tensor:
        if not x.is_meta:
            return -1
        key.append((x.shape, x.stride(), x.dtype))
        return 1
    if t in _PLAIN_SCALARS:
        key.append(t)
        key.append(x)
        return 0
    if t is list or t is tuple:
        key.append(len(x))
        n = 0
        for y in x:
            m = _meta_key_of(y, key)
            if m < 0:
                return -1
            n += m
        return n
    return -1


def _meta_key(func, args, kwargs):
    """The operation and its operands' metadata where every tensor
    operand is a plain ``meta`` tensor (at least one), else None."""
    at = _POSITION_FREE.get(func)
    if at is not None:
        args = args[:at] + (None,) + args[at + 1:]
    key = [id(func)]
    n = _meta_key_of(args, key)
    for k, v in kwargs.items():
        if n < 0:
            break
        key.append(k)
        m = _meta_key_of(v, key)
        n = -1 if m < 0 else n + m
    return tuple(key) if n > 0 else None


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
        self._refs = {}               # id -> (weak reference of a tracked
        #                               tensor, storage key) until it dies
        self._below = False           # a DTensor operation runs below
        # DTensor operations and rules recorded by ``_memo``: key ->
        # outputs' specs and shards, what they counted, bytes held (one
        # counter's: a spec names the mesh of its pair)
        self._records = {}
        # plain meta operations recorded by ``_plain_op``: key ->
        # outputs' metadata, what they counted
        self._plain = {}
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
        # a weak reference whose callback releases the storage's count,
        # kept until then (cheaper than ``weakref.finalize``)
        ref = weakref.ref(t, self._freed)
        self._refs[id(ref)] = (ref, key)

    def _freed(self, ref) -> None:
        entry = self._refs.pop(id(ref), None)
        if entry is not None:
            self._release(entry[1])

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
        if name in _SLICES:
            self.bytes += 2 * sum(_nbytes(t) for t in outs)
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

    # ------------------------------------------------ DTensor operations
    def _totals(self) -> tuple:
        return (self.flops, self.bytes,
                {k: dict(v) for k, v in self.collectives.items()},
                {d: {k: dict(v) for k, v in kinds.items()}
                 for d, kinds in self.collectives_by_dim.items()},
                dict(self.flops_by_op), dict(self.kernels))

    def _delta(self, before: tuple) -> tuple:
        """What was counted since ``_totals()`` returned ``before``:
        (flops, bytes, ((mesh dims, kind, count, bytes), ...), ((op,
        flops), ...), ((kernel, calls), ...))."""
        now = self._totals()
        colls = tuple(
            (dim, kind, v["count"] - was.get("count", 0),
             v["bytes"] - was.get("bytes", 0))
            for dim, kinds in now[3].items() for kind, v in kinds.items()
            for was in (before[3].get(dim, {}).get(kind, {}),)
            if v["count"] != was.get("count", 0))
        return (now[0] - before[0], now[1] - before[1], colls,
                tuple((k, v - before[4].get(k, 0)) for k, v in now[4].items()
                      if v != before[4].get(k, 0)),
                tuple((k, v - before[5].get(k, 0)) for k, v in now[5].items()
                      if v != before[5].get(k, 0)))

    def _add(self, delta: tuple) -> None:
        flops, n_bytes, colls, by_op, kernels = delta
        self.flops += flops
        self.bytes += n_bytes
        for dim, kind, count, n in colls:
            for rec in (self.collectives[kind],
                        self.collectives_by_dim.setdefault(dim, {})
                        .setdefault(kind, {"count": 0, "bytes": 0})):
                rec["count"] += count
                rec["bytes"] += n
        for table, pairs in ((self.flops_by_op, by_op),
                             (self.kernels, kernels)):
            for k, v in pairs:
                table[k] = table.get(k, 0) + v

    def _memo(self, key, run, args):
        """``run()``, which returns DTensors on meta shards computed from
        ``args``: run under this counter once for each key, which records
        what it counted, the tracked bytes it held at its peak and its
        outputs' specs, shards' metadata and whether each shard is new
        storage; later calls with the key add the record and return new
        DTensors of empty meta shards (new storage tracked).  A recurrence
        of thousands of steps (the sLSTM's) repeats a few dozen keys, and
        DTensor's dispatch with its redistributions is what such a step
        costs the host."""
        entry = self._records.get(key)
        if entry is not None:
            specs, delta, held = entry
            self._add(delta)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes + held)
            outs = []
            for spec, (shape, stride, dtype), new in specs:
                local = torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                if new:
                    self._track(local)
                outs.append(DTensor(local, spec, requires_grad=False))
            return outs[0] if len(outs) == 1 else tuple(outs)
        before, live, peak = self._totals(), self.live_bytes, self.peak_bytes
        self.peak_bytes = live
        try:
            out = run()
        finally:
            held = self.peak_bytes - live
            self.peak_bytes = max(peak, self.peak_bytes)
        if out is None:
            return None
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        if all(isinstance(t, DTensor) and t._local_tensor.device.type
               == "meta" for t in outs):
            held_by_args = {_storage_key(a._local_tensor)
                            for a in tree_leaves(args)
                            if isinstance(a, DTensor)}
            self._records[key] = (
                [(t._spec, (tuple(t._local_tensor.shape),
                            t._local_tensor.stride(), t._local_tensor.dtype),
                  _storage_key(t._local_tensor) not in held_by_args)
                 for t in outs], self._delta(before), held)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """A functional DTensor operation, or a view without autograd
        (where nothing reads a meta view's aliasing), through ``_memo``;
        anything else: None."""
        at = _POSITION_FREE.get(func)
        named = args if at is None else args[:at] + (None,) + args[at + 1:]
        key = (_dtensor_key(func, named, kwargs) if _functional(func)
               or (_view(func) and not torch.is_grad_enabled()) else None)
        if key is None:
            return None

        def run():
            self._below = True
            try:
                with self:
                    return func(*args, **kwargs)
            finally:
                self._below = False
        return self._memo(key, run, (args, kwargs))

    def _plain_op(self, key, func, args, kwargs):
        """A functional operation on plain ``meta`` tensors: run and
        counted once for each key, which records its outputs' metadata
        and what it counted; later calls with the key add the record and
        return new meta outputs (tracked), without the meta kernel,
        whose Python shape rules cost a recurrence's step more than the
        rest of its operations."""
        entry = self._plain.get(key)
        if entry is not None:
            metas, delta = entry
            self._add(delta)
            outs = []
            for shape, stride, dtype, offset, size in metas:
                t = torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                if offset or t.untyped_storage().nbytes() != size:
                    t = torch.empty(size, dtype=torch.uint8, device="meta"
                                    ).view(dtype).as_strided(shape, stride,
                                                             offset)
                self._track(t)
                outs.append(t)
            return outs[0] if len(outs) == 1 else tuple(outs)
        before = self._totals()
        out = func(*args, **kwargs)
        self._op(func, args, kwargs, out)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        for t in outs:
            self._track(t)
        ins = {_storage_key(t) for t in _tensors((args, kwargs))}
        if any(_storage_key(t) in ins for t in outs):
            _KINDS[id(func)] = _RUN   # an output aliases an operand
            return out
        self._plain[key] = (
            [(tuple(t.shape), t.stride(), t.dtype, t.storage_offset(),
              t.untyped_storage().nbytes()) for t in outs],
            self._delta(before))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._below:                # the one ``_dtensor_op`` runs
                self._below = False
                return NotImplemented      # count its local operations
            out = self._dtensor_op(func, args, kwargs)
            return NotImplemented if out is None else out
        if (torch._C._get_dispatch_mode(_FAKE) is not None
                or any(issubclass(t, FakeTensor) for t in types)):
            return func(*args, **kwargs)   # sharding propagation's shapes
        kind = _kind(func)
        if kind == _VIEW:
            return func(*args, **kwargs)   # neither counted nor tracked
        if kind >= _RECORD and not self.paused:
            key = _meta_key(func, args, kwargs)
            if key is not None:
                if kind == _RECORD:
                    return self._plain_op(key, func, args, kwargs)
                delta = self._plain.get(key)
                if delta is not None:
                    self._add(delta)
                    return args[0]
                before = self._totals()
                out = func(*args, **kwargs)
                self._op(func, args, kwargs, out)
                self._plain[key] = self._delta(before)
                return out
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


def open_counter():
    """The ``CostCounter`` open, where exactly one is; else None."""
    stack = (_get_current_dispatch_mode_stack()
             if torch._C._len_torch_dispatch_stack() else [])
    counters = [m for m in stack if isinstance(m, CostCounter)]
    return counters[0] if len(counters) == 1 else None


def memoized(tag: str, fn, *args):
    """``fn(*args)`` for a layout rule of ``launch.rules`` (DTensors in,
    DTensors out): with one ``CostCounter`` open and no gradient
    recorded, through the counter's record of the rule on these
    operands (``CostCounter._memo``), else as it is."""
    counter = open_counter()
    if counter is None or torch.is_grad_enabled():
        return fn(*args)
    key = _dtensor_key(tag, args, {})
    if key is None:
        return fn(*args)
    return counter._memo(key, lambda: fn(*args), args)


def analyze(fn, *args, mesh=None, groups=None, **kwargs) -> dict:
    """``CostCounter.totals()`` of one call ``fn(*args, **kwargs)``."""
    with CostCounter(mesh, groups) as counter:
        fn(*args, **kwargs)
    return counter.totals()
