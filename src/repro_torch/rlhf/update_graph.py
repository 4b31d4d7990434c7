"""The local update as a captured program.

Counterpart of the reference's ``_jit_local_step``
(``repro.fed.algorithms``): ``jax.jit`` of ``firm_local_step``, memoized
on ``(cfg, cfc)``, the client state donated.  Here one update of a
client-local algorithm (``firm_local_step`` or ``linear_local_step``: the
sequence forward, the M ``autograd.grad`` pulls, the Gram kernel, the
regularised MGDA solve, lambda's smoothing, Adam on the adapters, the
critics' TD update, the KL controller) becomes a CUDA graph.

``UpdateGraphs`` is one owner's set of graphs, one a key; a
``FederatedTrainer`` holds one and frees it with itself (a graph holds a
memory pool of gigabytes, so no cache outlives its owner).  For a key,
``run``:

1. on its first call runs the step eagerly on the device's side stream
   (``sampling.side_stream``): real work, and the warm-up of cuBLAS, the
   kernels' library and autograd's device thread;
2. on its second call copies the inputs into static buffers, captures one
   step on the side stream into a private memory pool of its own (decode
   graphs are captured anew every ``generate`` and replayed between this
   graph's replays, so sharing their pool would be unsafe), instantiates
   it and replays it once (the capture ran nothing);
3. on every later call copies the inputs in, replays, and copies out.

The inputs are the client state (every adapter, or every parameter
where the model has no adapters, Adam's moments and count, the critic,
lambda, the KL coefficient, the step), the five ``PPOBatch`` tensors,
the algorithm's operands (``firm``'s 0-d beta and the client's (M,)
preference if it has one, or ``linear``'s weights) and the modality
stub ``aux`` of a config with cross blocks, if any; the outputs are the
new state and every metric.  A
whole tree moves by one ``torch._foreach_copy_`` a dtype.  What is handed
back is fresh tensors: the caller's state is never written (the round's
clients share the broadcast adapters, which anchor the delta), and a
tensor handed back does not change at the next replay.

The key: ``cfg``; ``cfc`` with the fields the step never reads from the
config fixed (``_UNREAD``), so cohorts of different K, clients of
different preferences and updates of different beta share one graph; the
algorithm's ``kernel``; the device; the names of ``aux``'s entries; the
inputs' shapes and dtypes (an aux of another shape is another key); and
``(data_ptr, shape, stride, dtype)`` of every leaf of ``frozen``, which
the graph reads where it lay at the capture: a new frozen tree is a new
capture, while an in-place write to a leaf needs none.

The kernels' launch counters move for the replays as for the decode graph
(``kernels.counters``).  No Python garbage collection runs during a
capture (``sampling.no_collection``): a graph freed then, such as a
dropped trainer's, would end the capture.  No fallback: a capture or
replay that fails raises, and nothing runs the eager step in its place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import FIRMConfig, ModelConfig
from repro_torch.kernels import counters
from repro_torch.rlhf import sampling
from repro_torch.rlhf.local import ClientState
from repro_torch.rlhf.ppo import PPOBatch
from repro_torch.train.optim import AdamState
from repro_torch.trees import tree_leaves, tree_map

# FIRMConfig fields a local update never reads from the config, fixed in
# the key (the preference and beta ride the static operands instead)
_UNREAD = dict(n_clients=1, rounds=1, local_steps=1, batch_size=1,
               participation=1.0, client_preferences=None,
               client_local_steps=None, kl_coef_init=0.0, preference=None,
               beta=0.0)


def _state_leaves(state: ClientState) -> list:
    return (tree_leaves(state.trainable) + tree_leaves(state.critic)
            + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
            + [state.opt.count, state.lam, state.kl_coef, state.step])


def _state_like(like: ClientState, leaves) -> ClientState:
    """A ClientState shaped as ``like`` holding ``leaves`` (the order of
    ``_state_leaves``)."""
    it = iter(leaves)

    def take(tree):
        return tree_map(lambda _: next(it), tree)

    trainable, critic = take(like.trainable), take(like.critic)
    mu, nu = take(like.opt.mu), take(like.opt.nu)
    count, lam, kl_coef, step = it
    return ClientState(trainable, critic, AdamState(mu, nu, count), lam,
                       kl_coef, step)


def _copy(dsts, srcs) -> None:
    """dsts[i] <- srcs[i], one foreach copy a dtype."""
    groups: Dict[torch.dtype, tuple] = {}
    for d, s in zip(dsts, srcs):
        group = groups.setdefault(d.dtype, ([], []))
        group[0].append(d)
        group[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def _key(kernel: str, cfg: ModelConfig, cfc: FIRMConfig, inputs, frozen,
         aux_names=()):
    return (kernel, cfg, dataclasses.replace(cfc, **_UNREAD),
            inputs[0].device, tuple(aux_names),
            tuple((tuple(t.shape), t.dtype) for t in inputs),
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in tree_leaves(frozen)))


class _Entry:
    """One key's graph and its static buffers."""

    def __init__(self, graph):
        self.graph = graph
        self.inputs = self.outputs = self.names = self.per_replay = None


class UpdateGraphs:
    """One owner's captured local updates, one a key (see the module
    docstring).  ``new_graph(device)`` makes a graph object with
    ``warm(fn)``, ``capture(fn)`` (both return ``fn()``) and ``replay()``:
    by default ``UpdateGraph``, a CUDA graph; the tests pass a stand-in.
    ``captures`` counts the captures made."""

    def __init__(self, new_graph: Optional[Callable] = None):
        self._new_graph = new_graph or UpdateGraph
        self._entries: Dict[tuple, _Entry] = {}
        self.captures = 0

    def graph(self, kernel, cfg, cfc, state, frozen, batch, operands=(),
              aux=None):
        """The graph object these arguments' key holds, or None."""
        aux = aux or {}
        entry = self._entries.get(_key(
            kernel, cfg, cfc, self._inputs(state, batch, operands, aux),
            frozen, sorted(aux)))
        return None if entry is None else entry.graph

    def uncaptured(self) -> int:
        """Keys called once (warmed) and not yet captured."""
        return sum(entry.outputs is None for entry in self._entries.values())

    @staticmethod
    def _inputs(state, batch, operands, aux) -> list:
        return (_state_leaves(state) + list(batch) + list(operands)
                + [aux[name] for name in sorted(aux)])

    def run(self, kernel: str, step, cfg: ModelConfig, cfc: FIRMConfig,
            state: ClientState, frozen, batch: PPOBatch, operands=(),
            aux=None):
        """``step(cfg, cfc, state, frozen, batch, operands[, aux=aux])``
        -> (new state, metrics), through the key's graph.  ``kernel`` names
        the step program (``Algorithm.kernel``); ``operands`` is the tuple
        of its tensor operands; ``aux`` the modality stub, a dict of
        tensors, or None."""
        aux_names = sorted(aux or {})
        inputs = self._inputs(state, batch, operands, aux or {})
        key = _key(kernel, cfg, cfc, inputs, frozen, aux_names)
        entry = self._entries.get(key)
        n_state = len(inputs) - len(batch) - len(operands) - len(aux_names)
        n_ops = n_state + len(batch) + len(operands)

        def flat_step(args):
            st = _state_like(state, args[:n_state])
            b = PPOBatch(*args[n_state:n_state + len(batch)])
            ops = tuple(args[n_state + len(batch):n_ops])
            kw = ({"aux": dict(zip(aux_names, args[n_ops:]))} if aux_names
                  else {})
            new_state, metrics = step(cfg, cfc, st, frozen, b, ops, **kw)
            names = sorted(metrics)
            return (_state_leaves(new_state)
                    + [metrics[k] for k in names]), names

        if entry is None:
            # first call: the eager step, on the side stream
            graph = self._new_graph(inputs[0].device)
            flat, names = graph.warm(lambda: flat_step(inputs))
            self._entries[key] = _Entry(graph)
            return self._unflatten(state, flat, names)
        if entry.outputs is None:
            # second call: capture on static copies of the inputs
            entry.inputs = [torch.empty_like(t) for t in inputs]
            _copy(entry.inputs, inputs)
            before = counters.read()
            # graphs that dropped owners left in reference cycles are freed
            # now: none may be freed during the capture
            gc.collect()
            try:
                with sampling.no_collection():
                    entry.outputs, entry.names = entry.graph.capture(
                        lambda: flat_step(entry.inputs))
            except BaseException:
                del self._entries[key]
                raise
            entry.per_replay = counters.since(before)
            counters.add(entry.per_replay, -1)     # the capture ran nothing
            self.captures += 1
        else:
            _copy(entry.inputs, inputs)
        entry.graph.replay()
        counters.add(entry.per_replay)
        fresh = [torch.empty_like(t) for t in entry.outputs]
        _copy(fresh, entry.outputs)
        return self._unflatten(state, fresh, entry.names)

    @staticmethod
    def _unflatten(like: ClientState, flat, names):
        n = len(flat) - len(names)
        return _state_like(like, flat[:n]), dict(zip(names, flat[n:]))


class UpdateGraph:
    """One local update as a CUDA graph: warmed and captured on the
    device's side stream, into a private memory pool, and replayed on the
    current stream (``capture_begin``/``capture_end``, as the decode
    graph's).  Keeps the graph (``keep_graph``, for counting its nodes)
    and the seconds of its capture and instantiation."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.side = sampling.side_stream(self.device)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.capture_s = self.instantiate_s = None

    def warm(self, fn):
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        with torch.cuda.stream(self.side):
            out = fn()
        current.wait_stream(self.side)
        return out

    def capture(self, fn):
        current = torch.cuda.current_stream(self.device)
        # the allocator cannot free its cached blocks while a capture is
        # under way, so the pool's new segments must fit in what is free:
        # return the cache first (once a key, so the sync it costs is rare)
        torch.cuda.empty_cache()
        self.side.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(self.side):
            self.graph.capture_begin()          # a private pool
            try:
                out = fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        t1 = time.perf_counter()
        self.graph.instantiate()
        self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1
        current.wait_stream(self.side)
        return out

    def replay(self) -> None:
        self.graph.replay()
