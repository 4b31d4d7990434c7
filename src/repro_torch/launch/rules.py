"""What the steps do on DTensors where DTensor's own rules fall short.

The reference's programs are GSPMD's: XLA partitions every operation of
a step and reshards where it must.  The port's steps run under DTensor,
whose rules cover most operations.  This module holds the layout choices
the steps make where they do not, so that the model learns nothing of
DTensor or meshes.  ``StepRules`` is a ``TorchFunctionMode`` that every
step of ``launch.steps`` enters; an operation on plain tensors, or one
that no rule names, runs as it would without it.

  ``index_copy_`` into a DTensor sharded on the index dim (the decode
      step's slot write into ``cache_shardings``' sequence-sharded K/V):
      each rank writes the slot where its shard holds it, at its local
      offset, and leaves its shard as it is everywhere else; the slot is
      found on the device, with no host read.  One replicated index; a
      Partial, strided or uneven placement raises.  (DTensor's own
      ``index_copy_`` relabels such a tensor ``Replicate()`` without
      gathering it.)
  softmax over a sharded dim (the decode attention's scores over the
      sharded slots; ``decode=True`` only): the local softmax, rescaled
      by an all-reduce of the shards' maxima and one of their sums over
      each mesh dim that shards the dim, as GSPMD partitions it (DTensor
      would all-gather the scores).  On one shard the factor is exactly
      1: the plain softmax bit for bit.
  einsum: its operands laid out by ``plan_einsum`` (each mesh dim shards
      the index letter that costs least to lay out), then one einsum on
      the shards; an operand whole on a mesh dim that shards another's
      letter gets its gradient Partial there (the sum over that letter's
      shards), as the lookup's table does where the indices are
      sharded.  DTensor's own views shards that are not contiguous (and
      fails: the MoE experts' products) and plans strided shards for
      longer than a pair's time limit.
  reshape and view: a dim gathered first where a split or merge would
      break its shards' blocks (DTensor refuses the uneven split of 4
      heads over 16 cards, 2.11 the flatten of a sharded dim, and 2.13
      carries the merge as a strided shard); then, with no Partial
      placement, on the shard, gradients too; with one, DTensor's own.
  basic indexing without a gradient (``wx[:, t]`` of a recurrence): on
      the shard, past DTensor's propagation, which a changing Python int
      keys anew at every step.
  ``weight[idx]``, the embedding lookup: DTensor 2.13's own layout (the
      table gathered, the features then sliced), made explicit because
      2.11 refuses indices sharded over two mesh dims on one tensor dim.
  ``F.pad`` that DTensor's rule fails on (2.11's, in its planner): the
      padded dims gathered where sharded, the pad local.
  ``torch.cat`` that DTensor's rule fails on (operands Partial by a mean
      and by a sum): the operands laid out alike first, then one cat on
      the shards.
  ``common.scan`` (the xLSTM's recurrences): its operands laid out once
      before the loop (Partial sums reduced, dims but the batch
      gathered), then, where only the batch is sharded and the weights
      the body binds are replicated, its steps on the local shards, as
      GSPMD partitions a while loop over a batch-sharded carry; under a
      ``hlo_cost.CostCounter`` the middle steps are replayed
      (``launch.replay``).  Any other layout runs as the loop of DTensor
      operations.

Importing the module also registers a pointwise sharding strategy for
``aten.log_sigmoid_backward`` (the sLSTM forget gate's gradient), which
DTensor lacks, and one for ``aten.flip`` where the torch in use has none
(2.11; the mLSTM's ``cumsum`` flips in its backward), with
``torch.distributed.tensor.experimental.register_sharding``.  Under a
``hlo_cost.CostCounter`` the rules are
recorded once per key and replayed (``hlo_cost.memoized``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
from torch.distributed.tensor._utils import compute_global_tensor_info
from torch.distributed.tensor.experimental import register_sharding
from torch.overrides import TorchFunctionMode

from repro_torch.launch import hlo_cost, replay
from repro_torch.models import common

aten = torch.ops.aten
# the functional all-gathers, by the names of the torch in use (2.13
# renamed them; 2.11 has the old names only)
_ALL_GATHER = getattr(funcol, "all_gather_single", None) or \
    funcol.all_gather_tensor
_ALL_GATHER_AUTOGRAD = getattr(funcol, "all_gather_single_autograd", None) \
    or funcol.all_gather_tensor_autograd


@register_sharding(aten.log_sigmoid_backward.default)
def _log_sigmoid_backward(grad_output, self, buffer):
    """Pointwise in ``grad_output`` and ``self``; the forward's ``buffer``
    has ``self``'s shape on the CPU and on ``meta`` and is empty on CUDA,
    where it is replicated."""
    same = tuple(buffer.shape) == tuple(self.shape)
    out = [([Replicate()], [Replicate()] * 3)]
    for d in range(len(self.shape)):
        out.append(([Shard(d)], [Shard(d), Shard(d),
                                 Shard(d) if same else Replicate()]))
    return out


def _flip_sharding(self, dims):
    """``aten.flip``: the shards of every dim it does not flip, a Partial
    sum as it is (torch 2.11 has no strategy; the backward of the
    mLSTM's ``cumsum`` flips)."""
    flipped = {d % len(self.shape) for d in dims}
    out = [([Replicate()], [Replicate(), None]),
           ([Partial()], [Partial(), None])]
    for d in range(len(self.shape)):
        if d not in flipped:
            out.append(([Shard(d)], [Shard(d), None]))
    return out


def _has_strategy(op) -> bool:
    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, name, {}) for name in (
        "op_strategy_funcs", "op_single_dim_strategy_funcs", "op_to_rules"))


if not _has_strategy(aten.flip.default):
    register_sharding(aten.flip.default)(_flip_sharding)


def contiguous_strides(shape) -> tuple:
    return tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))


def _from_local(local: torch.Tensor, mesh, placements, shape,
                stride) -> DTensor:
    """``DTensor.from_local`` without a check; where no gradient flows,
    the DTensor made directly (``from_local``'s autograd function costs a
    recurrence's step more than the step's own operations)."""
    if local.requires_grad:
        return DTensor.from_local(local, mesh, tuple(placements),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(stride))
    spec = DTensorSpec(mesh, tuple(placements), tensor_meta=TensorMeta(
        torch.Size(shape), tuple(stride), local.dtype))
    return DTensor(local, spec, requires_grad=False)


def _wrap(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A DTensor of global ``shape`` from a contiguous local shard."""
    return _from_local(local.contiguous(), mesh, placements, shape,
                       contiguous_strides(tuple(shape)))


def _sharding_dims(x: DTensor, dim: int) -> list:
    """The mesh dims that shard tensor dim ``dim`` of ``x``, major first."""
    return [i for i, p in enumerate(x.placements) if p.is_shard(dim)]


def _block(x: DTensor, dims: list) -> int:
    """This rank's block along a tensor dim sharded over mesh ``dims``:
    DTensor splits over them in mesh order, the first the major one."""
    mesh, at = x.device_mesh, 0
    for i in dims:
        at = at * mesh.size(i) + mesh.get_local_rank(i)
    return at


def shard_local_index_copy(self: DTensor, dim: int, index, source):
    """``self.index_copy_(dim, index, source)`` for ``self`` sharded on
    ``dim``: this rank writes the slot if its shard holds it, at its
    local offset, and keeps its shard elsewhere; returns ``self``."""
    dim %= self.ndim
    mesh, pl = self.device_mesh, self.placements
    where = f"index_copy_ into {tuple(self.shape)} on dim {dim} ({pl})"
    if any(p.is_partial() for p in pl):
        raise NotImplementedError(f"{where}: a Partial tensor")
    dims = _sharding_dims(self, dim)
    if any(type(pl[i]) is not Shard for i in dims):
        raise NotImplementedError(f"{where}: a strided shard")
    shards = math.prod(mesh.size(i) for i in dims)
    if self.shape[dim] % shards:
        raise NotImplementedError(
            f"{where}: {self.shape[dim]} slots do not split over {shards} "
            "shards")
    if isinstance(index, DTensor):
        if any(not p.is_replicate() for p in index.placements):
            raise NotImplementedError(f"{where}: the index is laid out as "
                                      f"{index.placements}")
        index = index.to_local()
    if index.numel() != 1:
        raise NotImplementedError(f"{where}: {index.numel()} indices, not 1")
    if not isinstance(source, DTensor):
        source = DTensor.from_local(source, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    # the source as self is laid out, with the index dim whole
    src = source.redistribute(mesh, tuple(
        Replicate() if i in dims else p for i, p in enumerate(pl))).to_local()
    local = self.to_local()
    n = local.shape[dim]
    at = index.reshape(1).long() - _block(self, dims) * n
    hit = ((at >= 0) & (at < n)).reshape([1] * local.ndim)
    at = at.clamp(0, n - 1)
    keep = local.index_select(dim, at)
    local.index_copy_(dim, at, torch.where(hit, src.to(local.dtype), keep))
    return self


def sharded_softmax(x: DTensor, dim: int, dtype=None) -> DTensor:
    """Softmax over a tensor dim of ``x`` that mesh dims shard: the local
    softmax times exp(m - M) z / Z, m and z this shard's max and sum of
    exp(x - m), M the all-reduced max and Z the all-reduced sum of
    exp(m - M) z."""
    dim %= x.ndim
    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    x = x.redistribute(mesh, pl)
    local = x.to_local()
    if dtype is not None:
        local = local.to(dtype)
    groups = [mesh.get_group(i) for i in _sharding_dims(x, dim)]
    m = local.amax(dim, keepdim=True)
    big = m
    for g in groups:
        big = funcol.all_reduce(big, "max", g)
    w = torch.exp(local - m).sum(dim, keepdim=True) * torch.exp(m - big)
    total = w
    for g in groups:
        total = funcol.all_reduce(total, "sum", g)
    return _wrap(torch.softmax(local, dim) * (w / total), mesh, pl,
                 x.shape)


def pad_dtensor(x: DTensor, pad: tuple, mode: str = "constant",
                value=None) -> DTensor:
    """``F.pad`` of a DTensor: the padded dims gathered, the pad local."""
    n = len(pad) // 2
    padded = range(x.ndim - n, x.ndim)
    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_partial()
               or any(p.is_shard(d) for d in padded) else p
               for p in x.placements)
    out = F.pad(x.redistribute(mesh, pl).to_local(), pad, mode, value)
    shape = list(x.shape)
    for j in range(n):
        shape[-1 - j] += pad[2 * j] + pad[2 * j + 1]
    return _wrap(out, mesh, pl, shape)


def lookup(weight: DTensor, idx: DTensor) -> DTensor:
    """``weight[idx]`` for a table (V, d): the table gathered where its
    rows are sharded, each rank then keeping its slice of the features
    on those mesh dims (where no mesh dim also shards the indices), the
    lookup on this rank's indices; the rows come out laid out as the
    indices are and, on those mesh dims, sharded on the features.  This
    is DTensor 2.13's own layout for the vocab-sharded embedding, one
    all-gather of the table's shard; 2.11 refuses indices sharded over
    two mesh dims on one tensor dim."""
    if any(p.is_partial() for p in idx.placements) or weight.ndim != 2:
        raise NotImplementedError(f"a lookup of {weight.placements} with "
                                  f"indices laid out as {idx.placements}")
    mesh = weight.device_mesh
    whole = tuple(Replicate() if p.is_shard(0) or p.is_partial()
                  or p.is_shard(1) and q.is_shard() else p
                  for p, q in zip(weight.placements, idx.placements))
    sliced = tuple(Shard(1) if p.is_shard(0) and not q.is_shard() else w
                   for p, q, w in zip(weight.placements, idx.placements,
                                      whole))
    table = weight.redistribute(mesh, whole).redistribute(mesh, sliced)
    pl = tuple(q if q.is_shard() else Shard(idx.ndim) if w.is_shard(1)
               else Replicate() for q, w in zip(idx.placements, sliced))
    # a table whole on a mesh dim that shards the indices gathers its
    # gradient from this rank's rows only: Partial there
    grad_pl = tuple(Partial() if q.is_shard() and w.is_replicate() else w
                    for q, w in zip(idx.placements, sliced))
    return _wrap(table.to_local(grad_placements=grad_pl)[idx.to_local()],
                 mesh, pl, tuple(idx.shape) + tuple(weight.shape[1:]))


def _groups(ins, outs) -> list:
    """The dims of a reshape from ``ins`` to ``outs`` (no -1), grouped:
    (input dims, output dims) of equal product, size-1 dims left out."""
    ia = [d for d in range(len(ins)) if ins[d] != 1]
    oa = [d for d in range(len(outs)) if outs[d] != 1]
    i = j = 0
    groups = []
    while i < len(ia) and j < len(oa):
        gi, gj = [ia[i]], [oa[j]]
        pi, pj = ins[ia[i]], outs[oa[j]]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                gi.append(ia[i])
                pi *= ins[ia[i]]
                i += 1
            else:
                gj.append(oa[j])
                pj *= outs[oa[j]]
                j += 1
        groups.append((gi, gj))
    return groups


def gather_dims(x: DTensor, tensor_dims) -> DTensor:
    """``x`` with ``tensor_dims`` whole: each one's shards all-gathered
    over the mesh dims that split it, the minor one first (one
    functional all-gather each, differentiable where ``x`` has a
    gradient)."""
    mesh, pl = x.device_mesh, list(x.placements)
    local = x.to_local()
    gather = (_ALL_GATHER_AUTOGRAD if local.requires_grad else _ALL_GATHER)
    for d in tensor_dims:
        dims = _sharding_dims(x, d)
        if any(type(pl[i]) is not Shard for i in dims):
            raise NotImplementedError(f"gathering dim {d} of a tensor laid "
                                      f"out as {x.placements}")
        for i in reversed(dims):
            local = gather(local, d, mesh.get_group(i))
            pl[i] = Replicate()
    return _wrap(local, mesh, pl, x.shape)


def _target(x: DTensor, shape) -> list:
    shape = list(shape)
    if -1 in shape:
        rest = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = x.numel() // max(rest, 1)
    return shape


def local_reshape(x: DTensor, shape, view: bool = False):
    """``x.reshape(shape)`` (``x.view`` with ``view``) on the shard where
    every sharded dim of ``x`` stays a whole block of the output (it leads
    its group and the first factor there divides by its shards) and no
    placement is Partial.  Its gradient is reshaped on the shard too
    (DTensor would view a gradient laid out otherwise than the forward,
    which it may refuse), and DTensor's view propagation costs a step of
    a recurrence more than the rest of its operations.  The shard is
    what ``reshape`` (``view``) makes of the local tensor, a strided view
    where it is one, as on plain tensors.  None where it does not
    apply."""
    shape = _target(x, shape)
    mesh = x.device_mesh
    if any(type(p) not in (Shard, Replicate) for p in x.placements):
        return None
    local_shape, new_dim = list(shape), {}
    for gi, gj in _groups(tuple(x.shape), shape):
        for d in gi:
            dims = _sharding_dims(x, d)
            if not dims:
                continue
            shards = math.prod(mesh.size(i) for i in dims)
            if d != gi[0] or shape[gj[0]] % shards:
                return None
            new_dim[d] = gj[0]
            local_shape[gj[0]] = shape[gj[0]] // shards
    if any(p.is_shard() and p.dim not in new_dim for p in x.placements):
        return None                       # a sharded dim of size 1
    local = x.to_local()
    out = local.view(local_shape) if view else local.reshape(local_shape)
    pl = tuple(Shard(new_dim[p.dim]) if p.is_shard() else p
               for p in x.placements)
    return _from_local(out, mesh, pl, shape,
                       compute_global_tensor_info(out, mesh, pl)[1])


def _local_bytes(x: DTensor) -> int:
    return x.to_local().numel() * x.element_size()


def plan_einsum(equation: str, ops):
    """Placements for an einsum's operands under which it runs on the
    shards: (each operand's, the output's, the output's shape), or None
    (an ellipsis, a letter repeated in an operand, another mesh).

    Each mesh dim shards at most one index letter, in every operand that
    holds it.  For each mesh dim the letter is the one whose layout costs
    least: an operand already sharded so costs nothing, a replicated one
    is sliced for nothing, one sharded otherwise is gathered (its shard's
    bytes times the other shards) and a Partial one is reduced (twice
    its bytes); no letter gathers every sharded operand.  A contracted
    letter gives a Partial output.  DTensor's own einsum views shards that
    are not contiguous (and fails), and plans strided shards for the MoE
    experts' products for longer than a pair's time limit.
    """
    if "->" not in equation or "." in equation:
        return None
    ins, out = equation.replace(" ", "").split("->")
    ins = ins.split(",")
    if len(ins) != len(ops):
        return None
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    for letters, o in zip(ins, ops):
        if len(set(letters)) != len(letters) or len(letters) != o.ndim or (
                isinstance(o, DTensor) and o.device_mesh != mesh):
            return None
    chosen = []
    for i in range(mesh.ndim):
        n = mesh.size(i)
        candidates = {None}
        for letters, o in zip(ins, ops):
            if isinstance(o, DTensor) and o.placements[i].is_shard():
                candidates.add(letters[o.placements[i].dim])

        def cost(letter):
            total = 0
            for letters, o in zip(ins, ops):
                if not isinstance(o, DTensor):
                    continue
                p = o.placements[i]
                if p.is_partial():
                    total += 2 * _local_bytes(o)
                elif p.is_shard() and (type(p) is not Shard or letter is None
                                       or letters[p.dim] != letter):
                    total += (n - 1) * _local_bytes(o)
            return total
        chosen.append(min(sorted(candidates, key=str), key=cost))
    targets = [tuple(Shard(letters.index(c)) if c is not None and c in letters
                     else Replicate() for c in chosen) for letters in ins]
    out_pl = tuple(Replicate() if c is None else Shard(out.index(c))
                   if c in out else Partial() for c in chosen)
    sizes = {}
    for letters, o in zip(ins, ops):
        sizes.update(zip(letters, o.shape))
    return targets, out_pl, [sizes[letter] for letter in out]


def planned_einsum(equation: str, ops):
    """``torch.einsum`` on the shards, its operands laid out by
    ``plan_einsum``; None where the plan does not apply."""
    plan = plan_einsum(equation, ops)
    if plan is None:
        return None
    targets, out_pl, shape = plan
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    letters = equation.replace(" ", "").split("->")[0].split(",")
    # the letter each mesh dim shards: an operand without it holds it
    # whole, and its gradient, summed over that letter's shards, is Partial
    chosen = [next((x[p.dim] for x, p in zip(letters, (t[i] for t in targets))
                    if p.is_shard()), None) for i in range(mesh.ndim)]
    local = []
    for o, pl, x in zip(ops, targets, letters):
        if not isinstance(o, DTensor):
            o = _from_local(o, mesh, (Replicate(),) * mesh.ndim, o.shape,
                            o.stride())
        if tuple(o.placements) != pl:
            o = o.redistribute(mesh, pl)
        grad_pl = tuple(Partial() if c is not None and c not in x else p
                        for c, p in zip(chosen, pl))
        local.append(o.to_local(grad_placements=grad_pl))
    out = torch.einsum(equation, *local)
    # the shard as torch.einsum leaves it (a permuted view of its product
    # where it is one), uncopied, as on plain tensors
    return _from_local(out, mesh, out_pl, shape,
                       compute_global_tensor_info(out, mesh, out_pl)[1])


def _reshape(x: DTensor, shape, view: bool):
    """``local_reshape``, after ``reshape_layout`` where it does not
    apply as ``x`` is laid out; None where it does not apply then."""
    out = local_reshape(x, shape, view)
    if out is None:
        out = local_reshape(reshape_layout(x, shape), shape, view)
    return out


def reshape_layout(x: DTensor, shape) -> DTensor:
    """``x`` with a tensor dim gathered wherever a reshape to ``shape``
    would split or merge it so that its shards do not stay whole blocks:
    a sharded dim must lead its group and, where split, its first factor
    must divide by its shards.  DTensor refuses the uneven split
    ("Cannot unflatten unevenly sharded tensor") and carries the merge as
    a strided shard, whose every later redistribution splits the tensor
    into as many pieces as the merged dims hold; GSPMD reshards."""
    shape = _target(x, shape)
    mesh, gather = x.device_mesh, []
    for gi, gj in _groups(tuple(x.shape), shape):
        if len(gi) == 1 and len(gj) == 1:
            continue
        for d in gi:
            dims = _sharding_dims(x, d)
            shards = math.prod(mesh.size(i) for i in dims)
            if dims and (d != gi[0] or shape[gj[0]] % shards):
                gather.append(d)
    return gather_dims(x, gather) if gather else x


def basic_index(x: DTensor, index):
    """``x[index]`` for ints, slices and an Ellipsis that leave every
    sharded dim whole, run on the shard (a view, as DTensor's is) without
    DTensor's sharding propagation, which a Python int in the index
    (``wx[:, t]`` of a recurrence) keys anew at every step.  Used where
    no gradient is recorded (prefill, decode; the train steps' slices
    keep DTensor's own layout of their gradients); None where the index
    is anything else or cuts a sharded dim."""
    index = index if isinstance(index, tuple) else (index,)
    if not all(isinstance(i, (int, slice)) or i is Ellipsis for i in index)\
            or any(isinstance(i, bool) for i in index)\
            or sum(i is Ellipsis for i in index) > 1:
        return None
    if Ellipsis in index:
        at = index.index(Ellipsis)
        index = (index[:at] + (slice(None),) * (x.ndim - len(index) + 1)
                 + index[at + 1:])
    if len(index) > x.ndim:
        return None
    index = index + (slice(None),) * (x.ndim - len(index))
    new_dim, shape, stride = {}, [], []
    for d, i in enumerate(index):
        sharded = _sharding_dims(x, d)
        if isinstance(i, int):
            if sharded:
                return None
            continue
        if sharded and i != slice(None):
            return None
        new_dim[d] = len(shape)
        shape.append(len(range(*i.indices(x.shape[d]))))
        stride.append(x.stride(d) * (i.step or 1))
    pl = tuple(Shard(new_dim[p.dim]) if p.is_shard() else p
               for p in x.placements)
    if any(type(p) not in (Shard, Replicate) and not p.is_partial()
           for p in x.placements):
        return None
    return _from_local(x.to_local()[index], x.device_mesh, pl, shape,
                       stride)


def cat_dtensors(tensors, dim: int = 0) -> DTensor:
    """``torch.cat`` of DTensors laid out alike first: on each mesh dim
    their common placement, or replicated where they differ, where it
    shards the cat's dim, or where their Partial sums differ in kind."""
    ds = [t for t in tensors if isinstance(t, DTensor)]
    mesh, nd = ds[0].device_mesh, ds[0].ndim
    dim %= nd
    pl = []
    for i in range(mesh.ndim):
        kinds = {t.placements[i] for t in ds}
        if len(tensors) == len(ds) and len(kinds) == 1 and not next(
                iter(kinds)).is_shard(dim):
            pl.append(next(iter(kinds)))
        else:
            pl.append(Replicate())
    pl = tuple(pl)
    local = [(t.redistribute(mesh, pl) if isinstance(t, DTensor) else
              _from_local(t, mesh, (Replicate(),) * mesh.ndim, t.shape,
                          t.stride()).redistribute(mesh, pl)).to_local()
             for t in tensors]
    shape = list(ds[0].shape)
    shape[dim] = sum(t.shape[dim] for t in tensors)
    return _wrap(torch.cat(local, dim), mesh, pl, shape)


def _collectives(counter) -> int:
    return sum(c["count"] for c in counter.collectives.values())


def _batch_laid_out(t):
    """``t`` with each Partial placement reduced and each tensor dim but
    the batch (dim 0) gathered: Replicate where a placement is either."""
    if not isinstance(t, DTensor) or all(
            p.is_replicate() or type(p) is Shard and p.dim == 0
            for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(
        p if type(p) is Shard and p.dim == 0 else Replicate()
        for p in t.placements))


def scan_layout(body, carry, xs):
    """The operands of a ``common.scan`` (the tensors ``body`` binds, the
    carry, the xs) laid out once, before the loop, as a scan on the
    shards takes them: each Partial placement reduced, each dim but the
    batch gathered, and the carry and the xs sharded alike (each mesh
    dim shards the batch of all of them or of none).  A projection whose
    contracted dim is sharded (the xLSTM's gate pre-activations over
    'model') would otherwise enter every step as partial sums, each step
    reducing its slice, and a gate DTensor sharded otherwise than the
    rest (an mLSTM forget gate, at some widths) would be laid out a step
    at a time; GSPMD reduces a dot's partial sums where the dot is, and
    lays a while loop's operands out before it."""
    if isinstance(body, functools.partial):
        body = functools.partial(
            body.func, *common.map_tensors(_batch_laid_out, body.args),
            **common.map_tensors(_batch_laid_out, body.keywords))
    carry = common.map_tensors(_batch_laid_out, carry)
    xs = common.map_tensors(_batch_laid_out, xs)
    dts = [t for t in common.tensor_leaves((carry, xs))
           if isinstance(t, DTensor)]
    if dts and all(t.device_mesh == dts[0].device_mesh for t in dts):
        mesh = dts[0].device_mesh
        common_pl = tuple(Shard(0) if all(t.placements[i] == Shard(0)
                                          for t in dts) else Replicate()
                          for i in range(mesh.ndim))

        def alike(t):
            if (not isinstance(t, DTensor)
                    or tuple(t.placements) == common_pl):
                return t
            return t.redistribute(mesh, common_pl)
        carry = common.map_tensors(alike, carry)
        xs = common.map_tensors(alike, xs)
    return body, carry, xs


def grad_as_laid_out(t):
    """``t``, whose gradient is laid out as ``t`` is (a Partial one
    reduced, once): an identity through ``DTensor.from_local``, whose
    backward redistributes.  A scan's outputs pass it, so that, as in
    the forward, no partial sum enters the loop's backward steps."""
    if not isinstance(t, DTensor) or not t.requires_grad:
        return t
    return DTensor.from_local(t.to_local(), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def scan_on_shards(mode, body, carry, xs, dim: int = 0):
    """``common.scan(body, carry, xs, dim)`` over DTensors, its steps run
    on the local shards, as GSPMD partitions a while loop over a
    batch-sharded carry (a shard map); None, having run nothing, where it
    does not apply.

    It applies where every DTensor operand is laid out by Shard and
    Replicate only (no Partial), the tensors ``body`` binds are
    replicated, and the xs (all DTensors, scanned along ``dim`` >= 1)
    and the DTensor carries share one layout that shards at most their
    batch dim 0, evenly.  Step 0 runs as DTensor's own rules run it, in
    ``mode``: it lays out a plain carry (replicated, as the steps'
    ``implicit_replication`` reads it).  Where that step's carry and
    output are laid out as the xs are, and (under a ``CostCounter``) it
    ran no collective, the other steps run on the shards: the bound
    tensors' shards with a gradient Partial over the batch's mesh dims
    (each shard's rows add to it), the carry's and the xs' shards; the
    stacked outputs and the last carry are wrapped back with
    ``DTensor.from_local``.  ``to_local`` and ``from_local`` are
    differentiable, so the gradients flow through.  Otherwise the other
    steps too run under DTensor's rules, in ``mode``.

    ``body`` must keep the rows of its batch apart, as the xLSTM's cells
    do: row i of its outputs reads row i of its carry and slice only.
    """
    if dim < 1:
        return None
    bound = ((body.args, body.keywords)
             if isinstance(body, functools.partial) else ())
    consts, carries, seqs = (common.tensor_leaves(t)
                             for t in (bound, carry, xs))
    dts = [t for t in consts + carries + seqs if isinstance(t, DTensor)]
    if not dts or not all(isinstance(t, DTensor) for t in seqs):
        return None
    mesh, pl = seqs[0].device_mesh, tuple(seqs[0].placements)
    if any(t.device_mesh != mesh
           or any(type(p) not in (Shard, Replicate) for p in t.placements)
           for t in dts):
        return None
    if any(isinstance(t, DTensor) and any(p.is_shard() for p in t.placements)
           for t in consts):
        return None
    if any(p.is_shard() and p.dim != 0 for p in pl) or any(
            tuple(t.placements) != pl for t in seqs + carries
            if isinstance(t, DTensor)):
        return None
    batch = [i for i, p in enumerate(pl) if p.is_shard()]
    shards = math.prod(mesh.size(i) for i in batch)
    if any(t.shape[0] % shards for t in seqs + carries) or \
            seqs[0].shape[dim] < 2:
        return None
    counter = hlo_cost.open_counter()
    ran = counter and _collectives(counter)
    with mode:
        carry, y = body(carry, common.scan_slice(xs, 0, dim))
    outs = common.tensor_leaves((carry, y))
    if not all(isinstance(t, DTensor) and tuple(t.placements) == pl
               for t in outs) or (counter and _collectives(counter) != ran):
        with mode:
            return common.map_tensors(grad_as_laid_out, common.scan_loop(
                body, carry, xs, dim, start=1, ys=[y]))
    grad_pl = tuple(Partial() if i in batch else p
                    for i, p in enumerate(pl))
    if bound:
        local = common.map_tensors(
            lambda t: t.to_local(grad_placements=grad_pl)
            if isinstance(t, DTensor) else t, bound)
        body = functools.partial(body.func, *local[0], **local[1])
    loop = (common.scan_loop if counter is None else
            functools.partial(replay.counted_scan, counter))
    carry, ys = loop(body, common.map_tensors(DTensor.to_local, carry),
                     common.map_tensors(DTensor.to_local, xs), dim, 1,
                     [common.map_tensors(DTensor.to_local, y)])

    def wrap(t):
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return common.map_tensors(wrap, carry), common.map_tensors(wrap, ys)


_SOFTMAX = {torch.softmax, torch.Tensor.softmax, F.softmax}
_RESHAPE = {torch.Tensor.reshape, torch.Tensor.view, torch.reshape}
_PAD = {F.pad, torch._C._nn.pad}
_RULED = _SOFTMAX | _RESHAPE | _PAD | {torch.Tensor.index_copy_,
                                       torch.Tensor.__getitem__, torch.einsum,
                                       torch.cat}


class StepRules(TorchFunctionMode):
    """The rules above, while open; ``decode`` adds the sharded softmax
    (the serve step's)."""

    def __init__(self, decode: bool = False):
        super().__init__()
        self.decode = decode

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is common.scan:
            args = scan_layout(*args)
            out = scan_on_shards(self, *args, **kwargs)
            if out is None:
                with self:
                    out = common.map_tensors(
                        grad_as_laid_out, common.scan_loop(*args, **kwargs))
            return out
        if func not in _RULED:
            return func(*args, **kwargs)
        x = args[0] if args else None
        if (func is torch.Tensor.index_copy_ and isinstance(x, DTensor)
                and _sharding_dims(x, args[1] % x.ndim)):
            return shard_local_index_copy(*args, **kwargs)
        if self.decode and func in _SOFTMAX and isinstance(x, DTensor):
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            if dim is not None and _sharding_dims(x, dim % x.ndim):
                return sharded_softmax(x, dim, kwargs.get("dtype"))
        if func is torch.cat and any(isinstance(t, DTensor) for t in x):
            try:
                return func(*args, **kwargs)
            except (AssertionError, RuntimeError):
                # mixed Partial kinds (a mean's and a sum's gradients)
                return cat_dtensors(*args, **kwargs)
        if func in _PAD and isinstance(x, DTensor):
            try:
                return func(*args, **kwargs)
            except (IndexError, RuntimeError):
                # torch 2.11's rule for the pad fails in its planner
                return pad_dtensor(*args, **kwargs)
        if func is torch.Tensor.__getitem__ and isinstance(x, DTensor):
            if (isinstance(args[1], DTensor)
                    and not args[1].dtype.is_floating_point
                    and args[1].dtype != torch.bool):
                return lookup(*args)
            if not torch.is_grad_enabled():
                out = hlo_cost.memoized("index", basic_index, x, args[1])
                if out is not None:
                    return out
        if (func in _RESHAPE and isinstance(x, DTensor) and len(args) > 1
                and not isinstance(args[1], torch.dtype)):
            shape = args[1] if isinstance(args[1], (list, tuple,
                                                    torch.Size)) else args[1:]
            if not any(p.is_partial() for p in x.placements):
                out = hlo_cost.memoized("reshape", _reshape, x, tuple(shape),
                                        func is torch.Tensor.view)
                if out is not None:
                    return out
            return func(reshape_layout(x, shape), *args[1:], **kwargs)
        if func is torch.einsum:
            ops = args[1] if len(args) == 2 and isinstance(
                args[1], (list, tuple)) else args[1:]
            if any(isinstance(o, DTensor) for o in ops):
                out = hlo_cost.memoized("einsum", planned_einsum, args[0],
                                        tuple(ops))
                if out is not None:
                    return out
        return func(*args, **kwargs)
