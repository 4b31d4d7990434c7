"""Chrome/Perfetto trace-event rendering of the simulated schedule
(counterpart of ``repro.obs.trace``).

``TraceBuilder`` accumulates trace events in the Chrome trace-event JSON
format (the ``{"traceEvents": [...]}`` object form) that
https://ui.perfetto.dev opens directly.  Two processes:

  pid 1 "simulated schedule"  the scheduler's simulated clock.  Thread 0
        is the server (round/barrier spans, aggregation instants); thread
        c+1 is client c, whose per-round work renders as consecutive
        download / compute / upload spans (durations from the same
        ``core.comms`` time-from-bytes models the policies use, so span
        sums reproduce the reported simulated wall-clock exactly).
        Deadline drops are instants on the dropped client's track;
        fedbuff uploads connect to the aggregation that consumed them via
        flow arrows, and the event-queue depth renders as a counter
        track.
  pid 2 "host wall-clock"     real time: one span per program entry
        handed to ``add_host_spans`` (objects with ``name``, ``t0``,
        ``dur`` and ``compiled``), with compile-triggering calls flagged
        (``args.compiled``).

All simulated timestamps are seconds and render as microseconds (the
trace-event unit); host spans are offset to start at t=0 of their own
process so the two timelines don't visually interleave.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

SIM_PID = 1
HOST_PID = 2
SERVER_TID = 0

SIM_PROCESS_NAME = "simulated schedule"
HOST_PROCESS_NAME = "host wall-clock"


def _us(seconds: float) -> float:
    return float(seconds) * 1e6


class TraceBuilder:
    """Accumulates trace events; ``to_dict()``/``write()`` export them."""

    def __init__(self) -> None:
        self.events: List[dict] = []
        self._flow_id = 0
        self._named: set = set()

    # ------------------------------------------------------- metadata
    def _thread(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) in self._named:
            return
        self._named.add((pid, tid))
        self.events.append({"ph": "M", "pid": pid, "tid": tid, "ts": 0,
                            "name": "thread_name", "args": {"name": name}})

    # ------------------------------------------------------- simulated
    def client_span(self, client: int, t0: float,
                    segments: Sequence[Tuple[str, float]], *,
                    round_idx: Optional[int] = None,
                    extra: Optional[dict] = None) -> float:
        """Consecutive phase spans on client ``client``'s track starting
        at simulated ``t0``; returns the end time."""
        tid = client + 1
        self._thread(SIM_PID, tid, f"client {client}")
        t = t0
        for label, dur in segments:
            args = {"client": client}
            if round_idx is not None:
                args["round"] = int(round_idx)
            if extra:
                args.update(extra)
            self.events.append({"ph": "X", "pid": SIM_PID, "tid": tid,
                                "cat": "client", "name": label,
                                "ts": _us(t), "dur": _us(dur),
                                "args": args})
            t += dur
        return t

    def server_span(self, name: str, t0: float, dur: float,
                    args: Optional[dict] = None) -> None:
        self._thread(SIM_PID, SERVER_TID, "server")
        self.events.append({"ph": "X", "pid": SIM_PID, "tid": SERVER_TID,
                            "cat": "server", "name": name, "ts": _us(t0),
                            "dur": _us(dur), "args": args or {}})

    def instant(self, name: str, t: float, *, client: Optional[int] = None,
                args: Optional[dict] = None) -> None:
        tid = SERVER_TID if client is None else client + 1
        tname = "server" if client is None else f"client {client}"
        self._thread(SIM_PID, tid, tname)
        self.events.append({"ph": "i", "pid": SIM_PID, "tid": tid,
                            "cat": "server" if client is None else "client",
                            "name": name, "ts": _us(t), "s": "t",
                            "args": args or {}})

    def flow_start(self, name: str, t: float, *, client: int,
                   args: Optional[dict] = None) -> int:
        """Open a flow arrow at simulated ``t`` on a client track; the
        returned id closes it via ``flow_end``."""
        self._flow_id += 1
        self._thread(SIM_PID, client + 1, f"client {client}")
        self.events.append({"ph": "s", "pid": SIM_PID, "tid": client + 1,
                            "cat": "flow", "name": name, "ts": _us(t),
                            "id": self._flow_id, "args": args or {}})
        return self._flow_id

    def flow_end(self, name: str, t: float, flow_id: int,
                 args: Optional[dict] = None) -> None:
        self._thread(SIM_PID, SERVER_TID, "server")
        self.events.append({"ph": "f", "bp": "e", "pid": SIM_PID,
                            "tid": SERVER_TID, "cat": "flow", "name": name,
                            "ts": _us(t), "id": flow_id,
                            "args": args or {}})

    def counter(self, name: str, t: float, values: Dict[str, float]) -> None:
        self.events.append({"ph": "C", "pid": SIM_PID, "tid": SERVER_TID,
                            "cat": "counter", "name": name, "ts": _us(t),
                            "args": {k: float(v) for k, v in values.items()}})

    # ------------------------------------------------------- host time
    def add_host_spans(self, spans, t_base: Optional[float] = None) -> None:
        """Render host spans (perf_counter seconds; ``name``, ``t0``,
        ``dur``, ``compiled``) on the host process, offset so the first
        span starts at 0."""
        if not spans:
            return
        if t_base is None:
            t_base = min(s.t0 for s in spans)
        self._thread(HOST_PID, 0, "jit entry")
        for s in spans:
            self.events.append({
                "ph": "X", "pid": HOST_PID, "tid": 0, "cat": "host",
                "name": s.name, "ts": _us(s.t0 - t_base),
                "dur": _us(s.dur),
                "args": {"compiled": bool(s.compiled)}})

    # ------------------------------------------------------- export
    def to_dict(self) -> dict:
        meta = []
        for pid, pname in ((SIM_PID, SIM_PROCESS_NAME),
                           (HOST_PID, HOST_PROCESS_NAME)):
            if any(e["pid"] == pid for e in self.events):
                meta.append({"ph": "M", "pid": pid, "tid": 0, "ts": 0,
                             "name": "process_name",
                             "args": {"name": pname}})
        return {"traceEvents": meta + list(self.events),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> dict:
        d = self.to_dict()
        validate_trace(d)
        with open(path, "w") as f:
            json.dump(d, f, indent=1)
        return d


# ---------------------------------------------------------- validation
_REQUIRED = {"ph", "pid", "tid", "name"}
_KNOWN_PH = {"X", "B", "E", "i", "I", "M", "C", "s", "t", "f"}


def validate_trace(trace: dict) -> None:
    """Raise ValueError unless ``trace`` is well-formed Chrome
    trace-event JSON (object form).  Checks the shape constraints the
    Perfetto importer relies on; tests call this, and ``write`` always
    validates before touching disk."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    open_flows = set()
    for i, e in enumerate(events):
        missing = _REQUIRED - set(e)
        if missing:
            raise ValueError(f"event {i} missing keys {sorted(missing)}")
        if e["ph"] not in _KNOWN_PH:
            raise ValueError(f"event {i}: unknown phase {e['ph']!r}")
        if e["ph"] != "M":
            if "ts" not in e:
                raise ValueError(f"event {i}: non-metadata event lacks ts")
            if not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
                raise ValueError(f"event {i}: bad ts {e['ts']!r}")
        if e["ph"] == "X":
            if "dur" not in e or e["dur"] < 0:
                raise ValueError(f"event {i}: X event needs dur >= 0")
        if e["ph"] == "s":
            open_flows.add(e.get("id"))
        if e["ph"] == "f" and e.get("id") not in open_flows:
            raise ValueError(f"event {i}: flow end without start "
                             f"(id {e.get('id')!r})")


def span_seconds_by_track(trace: dict) -> Dict[Tuple[int, int], float]:
    """Sum of X-span durations (in seconds) per (pid, tid) — what the
    tests reconcile against the policies' reported simulated times."""
    out: Dict[Tuple[int, int], float] = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            key = (e["pid"], e["tid"])
            out[key] = out.get(key, 0.0) + e["dur"] / 1e6
    return out
