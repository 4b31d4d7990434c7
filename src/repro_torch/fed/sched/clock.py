"""Deterministic event-driven simulated clock for the federated scheduler
(counterpart of ``repro.fed.sched.clock``).

The scheduler never sleeps: client work is *computed* eagerly (results
depend only on the dispatch anchor and RNG stream, never on wall time)
and only its simulated duration flows through this module.  Events are
totally ordered by (time, insertion sequence), so simultaneous arrivals
— e.g. a homogeneous cohort dispatched together — resolve in dispatch
order and every run with the same seed replays the exact same schedule.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, List, Optional, Tuple


class SimClock:
    """Monotone simulated time in seconds."""

    def __init__(self) -> None:
        self.now: float = 0.0

    def advance_to(self, t: float) -> None:
        if t < self.now - 1e-12:
            raise ValueError(f"clock moving backwards: {t} < {self.now}")
        self.now = max(self.now, float(t))

    def advance_by(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"negative duration {dt}")
        self.now += float(dt)


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    seq: int                         # insertion order: deterministic ties
    item: Any = dataclasses.field(compare=False, default=None)


class EventQueue:
    """Min-heap of Events with a deterministic (time, seq) total order.

    ``tap``, when given, observes every mutation as ``tap(op, time,
    depth)`` with op in {"push", "pop"}, the event's scheduled time, and
    the post-mutation queue depth — a pure read-out (it cannot reorder
    or reject events) that the trace (``obs.trace``) renders as an
    in-flight counter track.
    """

    def __init__(self, tap: Optional[Callable[[str, float, int], None]]
                 = None) -> None:
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = 0
        self._tap = tap

    def push(self, time: float, item: Any) -> None:
        heapq.heappush(self._heap, (float(time), self._seq, item))
        self._seq += 1
        if self._tap is not None:
            self._tap("push", float(time), len(self._heap))

    def pop(self) -> Event:
        time, seq, item = heapq.heappop(self._heap)
        if self._tap is not None:
            self._tap("pop", time, len(self._heap))
        return Event(time, seq, item)

    def peek_time(self) -> float:
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
