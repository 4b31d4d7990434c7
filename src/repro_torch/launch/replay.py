"""A recurrence's step counted once and its count replayed, under
``hlo_cost.CostCounter``.

The reference's cost walker multiplies a while loop's body by its trip
count (``repro.launch.hlo_cost``).  ``counted_scan`` does that for a
``common.scan`` loop on plain ``meta`` tensors, which ``launch.rules.
scan_on_shards`` runs on the shards of a step's DTensors: the per-step
counts stay what the loop's own operations count, and a step of the
loop costs the host one autograd node instead of a few hundred counted
operations.

  forward: the first steps run until a step's inputs and outputs are laid
      out as the step's before it; that step's counts (flops, bytes,
      collectives, kernel calls), the peak of the bytes it held above
      what it started with, the layout of its outputs and what autograd
      saved of it (its inputs and outputs by storage, the rest as bytes)
      are recorded.  The steps up to the last three are then one
      ``_Replayed`` node each, which adds the record, makes the outputs
      (new ``meta`` tensors) and keeps what the step would have saved
      (the inputs and outputs themselves, and a buffer of the rest's
      bytes) until autograd releases it.
  backward: the last three steps run.  A step that runs takes its inputs
      through an identity node (``_Gate``), once each, so that the
      engine's sums of gradients outside the step are the same events for
      a step that runs and one that is replayed; the gate's backward marks
      where the step's backward ends (its inputs' gradients leave), a
      hook on the node that made its last output where it starts.  Each
      pull records the third-last step's backward counts, peak and the
      gradients it hands on, and each replayed node adds them and hands on
      new tensors laid out as those.

Without a gradient (prefill) the forward's record is all; with too few
steps, or outputs that alias an input, every step runs.
"""
from __future__ import annotations

import functools
import itertools

import torch

from repro_torch.models import common

# steps that run at the end of a replayed loop: the last, whose carry's
# gradient may be none; the one before; and the one whose backward is
# recorded, which gets the gradients a step in the middle gets
_TAIL = 3


class _Slot:
    """Where a tensor goes in a tree kept without its tensors."""


_SLOT = _Slot()


def _fill(tree, it):
    """``tree`` with its tensors (and slots) replaced, in order, from
    ``it``."""
    if isinstance(tree, torch.Tensor) or tree is _SLOT:
        return next(it)
    if isinstance(tree, dict):
        return {k: _fill(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, it) for v in tree)
    return tree


def _meta(t) -> tuple:
    return (tuple(t.shape), t.stride(), t.dtype, t.storage_offset(),
            t.untyped_storage().nbytes())


def _make(meta) -> torch.Tensor:
    """A new ``meta`` tensor laid out as ``meta`` says, on new storage."""
    shape, stride, dtype, offset, size = meta
    t = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    if offset or t.untyped_storage().nbytes() != size:
        t = torch.empty(size, dtype=torch.uint8, device="meta").view(
            dtype).as_strided(shape, stride, offset)
    return t


def _unique(ts) -> tuple:
    """(the distinct tensors of ``ts`` by identity, each entry's index
    among them); None entries map to None."""
    first, out, where = {}, [], []
    for t in ts:
        if t is None:
            where.append(None)
            continue
        if id(t) not in first:
            first[id(t)] = len(out)
            out.append(t)
        where.append(first[id(t)])
    return out, where


def _storage(t) -> int:
    return t.untyped_storage()._cdata


def _saved(outs, floor: int) -> list:
    """The tensors autograd saved for the nodes that made ``outs`` back to
    (not including) the node numbered ``floor``: each node's ``_saved_*``
    attributes."""
    found, seen = [], set()
    stack = [o.grad_fn for o in outs]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen or node._sequence_nr() <= floor:
            continue
        seen.add(id(node))
        for name in dir(node):
            if name.startswith("_saved_"):
                value = getattr(node, name)
                found += [t for t in (value if isinstance(value, (list, tuple))
                                      else (value,))
                          if isinstance(t, torch.Tensor)]
        stack += [fn for fn, _ in node.next_functions]
    return found


class _Record:
    """What a step that ran counted and kept: filled by the forward of a
    step in the middle and, each pull, by the third-last step's
    backward."""

    def __init__(self, counter):
        self.counter = counter
        self.fwd = None           # delta, peak, output layouts and map, saved
        self.bwd = None           # delta, peak, gradient layouts and map
        self.y_tree = None        # the structure of a step's output


class _Gate(torch.autograd.Function):
    """The identity on a step's tensors; its backward calls ``mark`` with
    the gradients passing through (None where it has none)."""

    @staticmethod
    def forward(ctx, mark, *ts):
        ctx.mark = mark
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.mark is not None:
            ctx.mark(grads)
        return (None,) + grads


class _Replayed(torch.autograd.Function):
    """A step not run: the record's counts, new outputs, and what the step
    would have saved, kept until autograd releases this node's."""

    @staticmethod
    def forward(ctx, record, *ins):
        ctx.record = record
        ctx.set_materialize_grads(False)
        c = record.counter
        delta, peak, metas, where, saved_in, saved_out, rest = record.fwd
        top, live = c.peak_bytes, c.live_bytes
        c._add(delta)
        outs = [_make(m) for m in metas]        # tracked at dispatch
        ledger = torch.empty(rest, dtype=torch.uint8, device="meta")
        ctx.save_for_backward(*(ins[i] for i in saved_in),
                              *(outs[j] for j in saved_out), ledger)
        c.peak_bytes = max(top, live + peak)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        record = ctx.record
        c = record.counter
        if record.bwd is None:
            raise RuntimeError("a replayed step's backward ran before the "
                               "step it replays recorded one")
        delta, peak, metas, where = record.bwd
        top, live = c.peak_bytes, c.live_bytes
        c._add(delta)
        made = [_make(m) for m in metas]
        c.peak_bytes = max(top, live + peak)
        return (None,) + tuple(None if j is None else made[j]
                               for j in where)


def _split(body):
    """(the body's function, its bound arguments, its bound keywords)."""
    if isinstance(body, functools.partial):
        return body.func, body.args, body.keywords
    return body, (), {}


def counted_scan(counter, body, carry, xs, dim: int, start: int, ys: list):
    """``common.scan_loop(body, carry, xs, dim, start, ys)`` on plain
    ``meta`` tensors under ``counter``, the middle steps replayed (see the
    module docstring)."""
    n = (xs if isinstance(xs, torch.Tensor) else xs[0]).shape[dim]
    grad = torch.is_grad_enabled()
    fn, args, kwargs = _split(body)
    record = _Record(counter)
    ys = list(ys)
    last_in = last_out = None
    t = start
    # no name here holds a step's tensors past the step: the loop's own
    # references are what a step's inputs live by
    while t < n:
        if record.fwd is not None and t < n - _TAIL:
            outs = (_Replayed.apply(record, *common.tensor_leaves(
                (args, kwargs, carry, common.scan_slice(xs, t, dim))))
                if grad else _replay_no_grad(record))
            outs = (outs,) if isinstance(outs, torch.Tensor) else outs
            it = iter([outs[j] for j in record.fwd[3]])
            del outs
            carry, y = _fill(carry, it), _fill(record.y_tree, it)
            del it
        else:
            recording = record.fwd is None and t < n - _TAIL and t > start
            x = common.scan_slice(xs, t, dim)
            # the inputs' layouts (a slice of the xs sits elsewhere each
            # step) and the outputs'
            in_metas = [_meta(i)[:3] for i in
                        common.tensor_leaves((args, kwargs, carry, x))]
            carry, y = _run_step(record, fn, args, kwargs, carry, x, grad,
                                 recording and last_in is not None,
                                 t == n - _TAIL and grad)
            del x
            out_metas = [_meta(o) for o in common.tensor_leaves((carry, y))]
            if (recording and record.fwd is not None
                    and (in_metas != last_in or out_metas != last_out)):
                record.fwd = None               # not yet a fixed point
            last_in, last_out = in_metas, out_metas
        ys.append(y)
        del y
        t += 1
    return carry, common.scan_stack(ys, dim)


def _replay_no_grad(record):
    c = record.counter
    delta, peak, metas = record.fwd[:3]
    top, live = c.peak_bytes, c.live_bytes
    c._add(delta)
    outs = [_make(m) for m in metas]
    c.peak_bytes = max(top, live + peak)
    return tuple(outs)


def _run_step(record, fn, args, kwargs, carry, x, grad, recording,
              record_bwd):
    """One step that runs, its inputs through a ``_Gate`` where a gradient
    is recorded; with ``recording``, its forward recorded; with
    ``record_bwd``, each pull's backward."""
    c = record.counter
    ins = common.tensor_leaves((args, kwargs, carry, x))
    diff = [k for k, i in enumerate(ins) if i.requires_grad]
    n_ins = len(ins)
    if grad:
        window = {}

        def start_bwd(grads):
            window["before"] = c._totals()
            window["live"], window["top"] = c.live_bytes, c.peak_bytes
            c.peak_bytes = c.live_bytes

        def end_bwd(grads):
            peak = c.peak_bytes - window["live"]
            c.peak_bytes = max(window["top"], c.peak_bytes)
            made, at = _unique(grads)
            where = [None] * n_ins
            for k, j in zip(diff, at):
                where[k] = j
            record.bwd = (c._delta(window["before"]), peak,
                          [_meta(g) for g in made], where)
        gated = _Gate.apply(end_bwd if record_bwd else None,
                            *(ins[k] for k in diff))
        gated = (gated,) if isinstance(gated, torch.Tensor) else gated
        swap = dict(zip(diff, gated))
        it = iter([swap.get(k, i) for k, i in enumerate(ins)])
        args_, kwargs_ = _fill(args, it), _fill(kwargs, it)
        carry_, x_ = _fill(carry, it), _fill(x, it)
    else:
        args_, kwargs_, carry_, x_ = args, kwargs, carry, x
    if recording:
        before, live, top = c._totals(), c.live_bytes, c.peak_bytes
        c.peak_bytes = live
        carry_out, y = fn(*args_, carry_, x_, **kwargs_)
        peak = c.peak_bytes - live
        c.peak_bytes = max(top, c.peak_bytes)
        delta = c._delta(before)
    else:
        carry_out, y = fn(*args_, carry_, x_, **kwargs_)
    outs, where = _unique(common.tensor_leaves((carry_out, y)))
    saved = (_saved(outs, gated[0].grad_fn._sequence_nr())
             if recording and grad and diff else [])
    record.y_tree = _fill(y, itertools.repeat(_SLOT))
    if recording:
        in_keys = [_storage(i) for i in ins]
        out_keys = [_storage(o) for o in outs]
        if any(k in in_keys for k in out_keys):
            record.fwd = None                   # an output aliases an input
        else:
            seen, rest = set(in_keys + out_keys), 0
            saved_in, saved_out = [], []
            for s in saved:
                k = _storage(s)
                if k in in_keys:
                    i = in_keys.index(k)
                    if i not in saved_in:
                        saved_in.append(i)
                elif k in out_keys:
                    j = out_keys.index(k)
                    if j not in saved_out:
                        saved_out.append(j)
                elif k not in seen:
                    seen.add(k)
                    rest += s.untyped_storage().nbytes()
            record.fwd = (delta, peak, [_meta(o) for o in outs], where,
                          saved_in, saved_out, rest)
    if grad and record_bwd:
        # the step's backward starts at its last node: the one that made
        # an output last, which the engine runs first of the step's
        nodes = [o.grad_fn for o in outs if o.grad_fn is not None]
        last = max(nodes, key=lambda node: node._sequence_nr())
        last.register_prehook(start_bwd)
    return carry_out, y
