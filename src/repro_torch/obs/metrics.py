"""Metrics pipeline: typed records flowing into pluggable sinks
(counterpart of ``repro.obs.metrics``).

A ``MetricsPipeline`` is the write path of the telemetry subsystem: the
engine and the scheduler policies push ``MetricRecord``s through it, and
one or more *sinks* persist them.  Three sinks ship:

  memory   append records to a list (always attached; ``pipeline.records``
           reads it back)
  jsonl    one JSON object per line, schema-stamped (the durable
           time-series format)
  csv      flat ``schema,kind,name,round,value,labels`` rows for
           spreadsheet-shaped consumers

Sink specs are strings so they thread through ``EngineConfig`` and
benchmark CLI flags without plumbing objects: ``"memory"``,
``"jsonl:PATH"``, ``"csv:PATH"``, or a comma-separated combination.

The pipeline is intentionally dumb on the hot path: the engine computes
round statistics on the device and copies them to the host ONCE a round
(or a fused chunk, ``FederatedTrainer._record``); only the summary dict
already on the host is fanned out here.  Emission reads nothing from the
device.
"""
from __future__ import annotations

import csv as csv_lib
import json
from typing import IO, List, Optional, Sequence

from repro_torch.obs.records import MetricRecord, records_from_round


class MemorySink:
    """Record list in memory — the default, and the read path of
    ``select`` and ``values``."""

    kind = "memory"

    def __init__(self) -> None:
        self.records: List[MetricRecord] = []

    def write(self, rec: MetricRecord) -> None:
        self.records.append(rec)

    def close(self) -> None:
        pass


class JsonlSink:
    """One schema-stamped JSON object per line."""

    kind = "jsonl"

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh: Optional[IO[str]] = None

    def write(self, rec: MetricRecord) -> None:
        if self._fh is None:
            self._fh = open(self.path, "w")
        self._fh.write(json.dumps(rec.to_json()) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class CsvSink:
    """Flat rows: schema,kind,name,round,value,labels (value/labels are
    JSON-encoded so vector series survive the trip)."""

    kind = "csv"
    FIELDS = ("schema", "kind", "name", "round", "value", "labels")

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh: Optional[IO[str]] = None
        self._writer = None

    def write(self, rec: MetricRecord) -> None:
        if self._fh is None:
            self._fh = open(self.path, "w", newline="")
            self._writer = csv_lib.writer(self._fh)
            self._writer.writerow(self.FIELDS)
        j = rec.to_json()
        self._writer.writerow([
            j["schema"], j["kind"], j["name"], j.get("round", ""),
            json.dumps(j["value"]), json.dumps(j.get("labels", {}))])

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            self._writer = None


def make_sink(spec: str):
    """``"memory"`` | ``"jsonl:PATH"`` | ``"csv:PATH"`` -> a sink."""
    kind, _, arg = spec.partition(":")
    if kind == "memory":
        return MemorySink()
    if kind == "jsonl":
        if not arg:
            raise ValueError("jsonl sink needs a path: 'jsonl:PATH'")
        return JsonlSink(arg)
    if kind == "csv":
        if not arg:
            raise ValueError("csv sink needs a path: 'csv:PATH'")
        return CsvSink(arg)
    raise ValueError(f"unknown sink spec {spec!r}; "
                     "expected memory | jsonl:PATH | csv:PATH")


class MetricsPipeline:
    """Fan-out of typed records to the attached sinks."""

    def __init__(self, sinks: Sequence = ()) -> None:
        self.sinks = list(sinks)
        mems = [s for s in self.sinks if isinstance(s, MemorySink)]
        if not mems:
            mem = MemorySink()
            self.sinks.insert(0, mem)
            mems = [mem]
        self._memory = mems[0]

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> "MetricsPipeline":
        """Comma-separated sink specs; None/"" -> memory only."""
        if not spec:
            return cls()
        return cls([make_sink(s.strip()) for s in spec.split(",")
                    if s.strip()])

    @property
    def records(self) -> List[MetricRecord]:
        return self._memory.records

    def emit(self, rec: MetricRecord) -> None:
        for sink in self.sinks:
            sink.write(rec)

    def emit_round(self, summary: dict, *, round: Optional[int] = None,
                   policy: Optional[str] = None) -> None:
        """The one entry point for a finished server round/aggregation."""
        for rec in records_from_round(summary, round=round, policy=policy):
            self.emit(rec)

    def emit_schedule(self, summary: dict, *,
                      round: Optional[int] = None,
                      policy: Optional[str] = None) -> None:
        """Emit only the scheduler-timing records of an annotated round
        summary.  The sync/deadline policies run ``run_round`` (which
        already emitted the ``round/`` and ``comm/`` records) and then
        add timing; this avoids double-emitting the engine records."""
        for rec in records_from_round(summary, round=round, policy=policy):
            if rec.name.startswith("sched/"):
                self.emit(rec)

    def select(self, name: str) -> List[MetricRecord]:
        """All in-memory records with the given name, in emission order."""
        return [r for r in self.records if r.name == name]

    def values(self, name: str) -> list:
        """The value trajectory of one metric name."""
        return [r.value for r in self.select(name)]

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()

    def __enter__(self) -> "MetricsPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
