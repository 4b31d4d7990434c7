"""Program-entry instrumentation: calls, graph captures, host time and
kernel launches (counterpart of ``repro.obs.jitwatch``).

The engine wraps every program it runs with ``wrap(name, fn)``: the
reference's jitted programs, whose counterparts here are the functions that
run a stage of the round (``generate``, ``ref_logprobs``,
``step[<kernel>]``, ``stack_trees``, ``delta_flat``, ``flat_aggregate``,
``summary_device`` and FedCMOO's exchange programs).  When no recorder is
active (and the NaN check of ``debug.set_debug_nan`` is off) the wrapper
is one global check on top of the call.  Inside a ``record()`` context
each call logs a ``JitSpan``: the program's name, the call's entry on the
host clock, its duration (the host's dispatch time: no synchronise, no
host read) and whether THIS call captured a CUDA graph into a cache that
later calls replay from, the port's counterpart of a jit-cache miss.  That
signal comes from ``captures``, a callable that returns a count, in the
role of JAX's ``fn._cache_size``: ``UpdateGraphs.captures`` for the
update.  A ``generate`` span is never ``compiled``: its decode graph is
captured anew every call by design (``sampling.decode_captures`` counts
those captures).

A ``JitLog`` also holds the hand-written kernels' launches over its
window (``kernels.counters``: read at entry, ``since`` at exit), replays
of captured graphs included.

Two consumers: the plan audit (``obs.audit``) counts captures, calls and
launches a run and reconciles them with the plan; ``TraceBuilder.
add_host_spans`` renders the spans on the host wall-clock process of a
trace.  ``record()`` nests: every active recorder sees every span, and
each reads the launches of its own window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from collections import Counter
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class JitSpan:
    name: str
    t0: float                 # perf_counter seconds at call entry
    dur: float                # seconds spent in the call (dispatch time)
    compiled: bool            # did this call capture a graph into a cache?


class JitLog:
    """Spans collected by one ``record()`` context, and the kernels'
    launches over it (name -> launches; the counters that moved)."""

    def __init__(self) -> None:
        self.spans: List[JitSpan] = []
        self.launches: Dict[str, int] = {}

    @property
    def call_count(self) -> int:
        return len(self.spans)

    @property
    def compile_count(self) -> int:
        return sum(1 for s in self.spans if s.compiled)

    def calls_by_name(self) -> Dict[str, int]:
        return dict(Counter(s.name for s in self.spans))

    def compiles_by_name(self) -> Dict[str, int]:
        return dict(Counter(s.name for s in self.spans if s.compiled))


_STACK: List[JitLog] = []
# the context each wrapped call runs in while the NaN check is on
# (``debug.set_debug_nan``), given the program's name; None when off
_nan_check: Optional[Callable] = None
# a recorder is active or the NaN check is on: the wrappers' one check
_live = False


def _refresh() -> None:
    global _live
    _live = bool(_STACK) or _nan_check is not None


def set_nan_check(scope: Optional[Callable]) -> None:
    """Run every wrapped call inside ``scope(name)`` (None: plainly)."""
    global _nan_check
    _nan_check = scope
    _refresh()


@contextlib.contextmanager
def record(log: Optional[JitLog] = None):
    """Activate span recording for the dynamic extent of the block."""
    from repro_torch.kernels import counters
    log = JitLog() if log is None else log
    before = counters.read()
    _STACK.append(log)
    _refresh()
    try:
        yield log
    finally:
        _STACK.remove(log)
        _refresh()
        for name, n in counters.since(before).items():
            log.launches[name] = log.launches.get(name, 0) + n


def active() -> bool:
    return bool(_STACK)


def wrap(name: str, fn, captures: Optional[Callable[[], int]] = None):
    """Wrap a program; spans flow to every active recorder.

    ``captures``, if given, returns the number of graphs the program's
    cache has captured so far: a call during which it grows is
    ``compiled``.  The wrapper passes its arguments through unchanged.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _live:
            return fn(*args, **kwargs)
        return _call(name, fn, captures, args, kwargs)

    wrapped._jitwatch_name = name
    wrapped._wrapped_jit = fn
    return wrapped


def _call(name, fn, captures, args, kwargs):
    before = captures() if captures is not None else 0
    t0 = time.perf_counter()
    if _nan_check is None:
        out = fn(*args, **kwargs)
    else:
        with _nan_check(name):
            out = fn(*args, **kwargs)
    dur = time.perf_counter() - t0
    if _STACK:
        span = JitSpan(name, t0, dur,
                       captures is not None and captures() > before)
        for log in _STACK:
            log.spans.append(span)
    return out
