"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell names a configuration and a traffic mix.  The configuration's
file is the one its ``configs`` entry names; the traffic mix is
``bench/traffic/<traffic>.json``; the comparison's limits are
``bench/limits/<cell>.json``; each metric is read by
``bench/metrics/<metric>.py``, a module with ``read(ctx)`` that returns
the value or None when the run has nothing to read it from.  A new cell
or metric is new files and a new entry, never an edit.

Every name must be 1 to 64 of ``A-Za-z0-9_.-``, starting with a letter,
a digit or ``_``; every unit 1 to 16 of ``A-Za-z0-9_/%.-``.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class LayoutError(ValueError):
    """A name, unit or file the benchmark cannot resolve."""


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise LayoutError(f"bad name {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise LayoutError(f"bad unit {unit!r}")
    return unit


def _json(path: Path):
    if not path.is_file():
        raise LayoutError(f"missing {path}")
    return json.loads(path.read_text())


class Layout:
    """The benchmark at ``root``: ``BENCHMARK.json`` and ``bench/``."""

    def __init__(self, root):
        self.root = Path(root)
        self.spec = _json(self.root / "BENCHMARK.json")
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            for entry in self.spec[key]:
                check_name(entry["name"])
        for entry in self.spec["end_to_end"] + self.spec["per_layer"]:
            check_unit(entry["unit"])
        for entry in self.spec["workloads"]:
            check_name(entry["config"])
            check_name(entry["traffic"])

    def workload(self, name: str) -> dict:
        for entry in self.spec["workloads"]:
            if entry["name"] == check_name(name):
                return entry
        raise LayoutError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == check_name(name):
                cfg = _json(self.root / entry["file"])
                if cfg["name"] != name:
                    raise LayoutError(f"{entry['file']} holds {cfg['name']!r}")
                return cfg
        raise LayoutError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.root / "bench" / "traffic" / f"{check_name(name)}.json")

    def limits(self, cell: str) -> dict:
        return _json(self.root / "bench" / "limits" / f"{check_name(cell)}.json")

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of ``cell`` reports: the end-to-end
        ones without a trace, the per-layer ones with it.  A metric that
        lists ``workloads`` is reported there; one without it wherever
        the end-to-end metric it moves is."""
        e2e = [m for m in self.spec["end_to_end"] if cell in
               m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``bench/metrics/<metric>.py``."""
        path = self.root / "bench" / "metrics" / f"{check_name(metric)}.py"
        if not path.is_file():
            raise LayoutError(f"missing reader {path}")
        spec = importlib.util.spec_from_file_location(
            "firmbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
