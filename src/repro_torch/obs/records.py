"""Versioned metric records and the one round-summary constructor
(counterpart of ``repro.obs.records``).

Every telemetry datum is one of three typed records:

  counter  a cumulative quantity (wire bytes) — sinks may diff
           consecutive values
  gauge    an instantaneous scalar (lambda disagreement, param drift, KL,
           simulated round duration)
  series   a small vector sampled once a round (rewards by objective,
           mean lambda, upload bytes by client)

Records carry ``schema=SCHEMA_VERSION`` so that a reader can reject a file
written under another layout.  This module is also the one place a round
summary is built: ``round_summary`` serves ``run_round`` and the fused
chunk alike, and ``annotate_schedule`` / ``fedbuff_summary`` hold the
scheduler policies' additions.  The port keeps its own copy (the
reference's package imports JAX): the names, kinds, labels, values and
the summaries' keys and order are the reference's, and tests hold the two
equal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

SCHEMA_VERSION = 1

KINDS = ("counter", "gauge", "series")


def _plain(value):
    """Numpy scalars and arrays -> JSON-able python values."""
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    arr = np.asarray(value)
    if arr.ndim == 0:
        return arr.item()
    return arr.tolist()


@dataclasses.dataclass(frozen=True)
class MetricRecord:
    """One typed telemetry datum."""
    kind: str                               # counter | gauge | series
    name: str                               # e.g. "round/rewards"
    value: Any                              # scalar or (for series) list
    round: Optional[int] = None             # server round / version index
    labels: Tuple[Tuple[str, str], ...] = ()
    schema: int = SCHEMA_VERSION

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown record kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    def to_json(self) -> dict:
        d = {"schema": self.schema, "kind": self.kind, "name": self.name,
             "value": _plain(self.value)}
        if self.round is not None:
            d["round"] = int(self.round)
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


def counter(name: str, value, round: Optional[int] = None,
            **labels) -> MetricRecord:
    return MetricRecord("counter", name, _plain(value), round,
                        tuple(sorted((k, str(v)) for k, v in labels.items())))


def gauge(name: str, value, round: Optional[int] = None,
          **labels) -> MetricRecord:
    return MetricRecord("gauge", name, _plain(value), round,
                        tuple(sorted((k, str(v)) for k, v in labels.items())))


def series(name: str, value, round: Optional[int] = None,
           **labels) -> MetricRecord:
    return MetricRecord("series", name, _plain(value), round,
                        tuple(sorted((k, str(v)) for k, v in labels.items())))


# ------------------------------------------------- round-summary builders
def round_summary(*, stats: Dict[str, Any], comm_bytes: int, up_bytes: int,
                  down_bytes: int, participants: Sequence[int],
                  dispatches: float, up_nbytes: Sequence[int],
                  down_nbytes: int, local_steps: Sequence[int],
                  cohorts: int, fused: Optional[int] = None) -> dict:
    """The engine's per-round summary dict, for the per-round and the
    fused executors alike.

    ``stats`` holds the round's statistics on the host (numpy arrays and
    scalars): rewards, lam_mean, lam_disagreement, param_drift, kl,
    per_client_lam, rewards_per_client.  ``fused``, the length of the
    fused chunk the round ran in, is the last key, present only then.
    """
    summary = {
        "rewards": stats["rewards"],
        "lam_mean": stats["lam_mean"],
        "lam_disagreement": float(stats["lam_disagreement"]),
        "param_drift": float(stats["param_drift"]),
        "kl": float(stats["kl"]),
        "comm_bytes": comm_bytes,
        "up_bytes": up_bytes,
        "down_bytes": down_bytes,
        "participants": list(participants),
        "per_client_lam": stats["per_client_lam"],
        "rewards_per_client": stats["rewards_per_client"],
        "dispatches": dispatches,
        "up_nbytes": list(up_nbytes),
        "down_nbytes": down_nbytes,
        "local_steps": list(local_steps),
        "cohorts": cohorts,
    }
    if fused is not None:
        summary["fused"] = fused
    return summary


def annotate_schedule(summary: dict, *, policy: str, sim_time: float,
                      round_duration: float, dropped: Sequence[int],
                      client_seconds: Sequence[float], **extra) -> dict:
    """The sync/deadline policies' timing additions to an engine summary."""
    summary.update(policy=policy, sim_time=sim_time,
                   round_duration=round_duration, dropped=list(dropped),
                   client_seconds=[round(d, 6) for d in client_seconds],
                   **extra)
    return summary


def fedbuff_summary(*, version: int, sim_time: float, round_duration: float,
                    participants: Sequence[int], staleness: Sequence[int],
                    staleness_weights: Sequence[float], rewards,
                    rewards_per_client, comm_bytes: int, up_bytes: int,
                    down_bytes: int) -> dict:
    """One buffered-async aggregation's summary (fedbuff policy)."""
    return {
        "policy": "fedbuff",
        "version": version,
        "sim_time": sim_time,
        "round_duration": round_duration,
        "participants": list(participants),
        "staleness": list(staleness),
        "staleness_weights": [float(x) for x in staleness_weights],
        "rewards": rewards,
        "rewards_per_client": rewards_per_client,
        "comm_bytes": comm_bytes,
        "up_bytes": up_bytes,
        "down_bytes": down_bytes,
    }


# ------------------------------------------------- summary -> records
def records_from_round(summary: dict, *, round: Optional[int] = None,
                       policy: Optional[str] = None) -> List[MetricRecord]:
    """Fan one round-summary dict out into typed records.

    Emits a stable set of names under the ``round/`` (engine),
    ``comm/`` (ledger) and ``sched/`` (policy timing) prefixes; keys
    absent from the summary (e.g. ``sim_time`` on a bare engine run) are
    simply skipped.
    """
    labels = {"policy": policy} if policy else {}
    if "policy" in summary and not policy:
        labels = {"policy": summary["policy"]}
    out: List[MetricRecord] = []

    def g(name, key):
        if key in summary:
            out.append(gauge(name, summary[key], round, **labels))

    def s(name, key):
        if key in summary:
            out.append(series(name, summary[key], round, **labels))

    def c(name, key):
        if key in summary:
            out.append(counter(name, summary[key], round, **labels))

    s("round/rewards", "rewards")
    s("round/lam_mean", "lam_mean")
    g("round/lam_disagreement", "lam_disagreement")
    g("round/param_drift", "param_drift")
    g("round/kl", "kl")
    g("round/dispatches", "dispatches")
    g("round/cohorts", "cohorts")
    s("round/local_steps", "local_steps")
    c("comm/total_bytes", "comm_bytes")
    c("comm/up_bytes", "up_bytes")
    c("comm/down_bytes", "down_bytes")
    s("comm/up_nbytes", "up_nbytes")
    g("comm/down_nbytes", "down_nbytes")
    g("sched/sim_time", "sim_time")
    g("sched/round_duration", "round_duration")
    s("sched/client_seconds", "client_seconds")
    if "dropped" in summary:
        out.append(gauge("sched/dropped", len(summary["dropped"]), round,
                         **labels))
    if "staleness" in summary:
        st = summary["staleness"]
        out.append(gauge("sched/staleness_max",
                         max(st) if len(st) else 0, round, **labels))
        out.append(series("sched/staleness", st, round, **labels))
    return out
