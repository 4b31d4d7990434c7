"""Plan auditor: reconcile an ExecutionPlan's predictions with an observed
run (counterpart of ``repro.obs.audit``).

``fed.api.plan()`` predicts, before anything is allocated, how a run will
execute: the executor and the exact wire bytes a round.  ``audit_run``
runs a trainer while counting what actually happens (through
``obs.jitwatch``, every program call and kernel launch; the comms ledger,
the update graphs' captures and the copies to the host) and fails loudly
when prediction and observation drift:

    report = audit_run(trainer, rounds=4)
    report.raise_on_drift()          # PlanDriftError lists mismatches

Checks (the reference's names) and their enforcement:

  dispatches_per_round   the port's programs a round (``predicted_
                         dispatches``) against the program calls in the
                         audit's ``jitwatch.record()`` window / rounds;
                         enforced under the sync policy
  up/down_bytes_per_round  plan bytes vs ledger delta / rounds; enforced
                         under sync (deadline's dropped clients' downlinks
                         and fedbuff's redispatches are reported only)
  recompiles_after_warmup  0 vs the update graphs' captures during the
                         audited run; enforced whenever it warmed up first
  host_transfers_per_round  observed only: one copy to the host a round,
                         one a fused chunk

Where the port differs from the reference:

* ``dispatches_per_round``.  The reference counts its jitted dispatches
  by hand on the trainer (``jit_dispatches``), and the plan's
  ``dispatches_per_round`` is that count (the summary's ``dispatches``
  too).  The port's trainer keeps no such counter: the audit counts the
  calls of the wrapped programs in its own ``record()`` window
  (``JitLog.call_count``), so a newly wrapped stage counts without more
  code.  Nor does the port run the reference's programs: it runs
  each client-step on its own in every executor, and a fused chunk is the
  round's body R times.  Its programs (the stages ``obs.jitwatch`` wraps)
  a round are ``programs_per_client_step`` x the client-steps (3 for
  ``firm``, ``firm_unreg`` and ``linear``: generate, ref_logprobs, step;
  4 for ``fedcmoo``: its gradients and their application besides),
  ``programs_per_step`` x K (fedcmoo's one stack of the gradients a step),
  one stack of the clients' adapters (one more a cohort in the cohort
  mode) and delta_flat, flat_aggregate and summary_device: for ``firm``
  that is the reference loop executor's formula
  (``api._dispatch_estimate``), whatever the executor.  The check holds
  the port's own count; the report keeps the plan's (the reference's) as
  ``reference_dispatches_per_round``.
* ``recompiles_after_warmup``.  The port's counterpart of a jit-cache
  miss is an update graph's capture (``UpdateGraphs.captures``), which
  happens on a key's second call: a warm-up of one chunk leaves a key
  that saw one client-step in it (C = 1, K = 1) warmed but not captured.
  So the warm-up runs one chunk, and one more if a key is still
  uncaptured (``UpdateGraphs.uncaptured``).
* ``decode_captures_per_round``, observed only and outside the checks:
  decode captures its step's graph anew every call (``sampling.decode``),
  one a client-step, so it is no cache miss.  The report also gives the
  kernels' launches a round (``launches_per_round``, replays included)
  and the audited window's host seconds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch.obs import jitwatch

# the round's programs after the local phase: delta_flat, flat_aggregate,
# summary_device
ROUND_PROGRAMS = 3


class PlanDriftError(RuntimeError):
    """Predicted-vs-observed mismatch an audit was asked to enforce."""


@dataclasses.dataclass(frozen=True)
class AuditCheck:
    name: str
    predicted: Optional[float]
    observed: float
    enforced: bool

    @property
    def ok(self) -> bool:
        if self.predicted is None or not self.enforced:
            return True
        return abs(self.predicted - self.observed) <= 1e-6

    def to_json(self) -> dict:
        return {"name": self.name, "predicted": self.predicted,
                "observed": self.observed, "enforced": self.enforced,
                "ok": self.ok}


@dataclasses.dataclass
class AuditReport:
    algorithm: str
    executor: str
    policy: str
    uplink_codec: str
    downlink_codec: str
    rounds: int
    checks: List[AuditCheck]
    jit_calls: int
    compiles_by_name: dict
    # the port's own observations (see the module docstring)
    reference_dispatches_per_round: float = 0.0
    decode_captures_per_round: float = 0.0
    launches_per_round: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    def raise_on_drift(self) -> "AuditReport":
        bad = [c for c in self.checks if not c.ok]
        if bad:
            lines = [f"  {c.name}: predicted={c.predicted} "
                     f"observed={c.observed}" for c in bad]
            raise PlanDriftError(
                f"plan drift on {self.algorithm}/{self.executor}"
                f"/{self.uplink_codec} ({self.policy} policy):\n"
                + "\n".join(lines))
        return self

    def to_json(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "executor": self.executor,
            "policy": self.policy,
            "uplink_codec": self.uplink_codec,
            "downlink_codec": self.downlink_codec,
            "rounds": self.rounds,
            "ok": self.ok,
            "checks": [c.to_json() for c in self.checks],
            "jit_calls": self.jit_calls,
            "compiles_by_name": dict(self.compiles_by_name),
            "reference_dispatches_per_round":
                self.reference_dispatches_per_round,
            "decode_captures_per_round": self.decode_captures_per_round,
            "launches_per_round": dict(self.launches_per_round),
            "seconds": self.seconds,
        }


def predicted_dispatches(plan) -> float:
    """The port's programs a round under ``plan`` (see the module
    docstring); participant subsets use the population's mean K, as the
    planner's estimate does."""
    from repro_torch.fed.algorithms import client_configs, get_algorithm
    alg = get_algorithm(plan.algorithm)
    cfcs = client_configs(alg, plan.spec.firm)
    mean_k = sum(fc.local_steps for fc in cfcs) / len(cfcs)
    stacks = 1 + (len(plan.cohorts) if plan.local_mode == "cohort" else 0)
    return (alg.programs_per_client_step * plan.participants_per_round
            * mean_k + alg.programs_per_step * mean_k + stacks
            + ROUND_PROGRAMS)


def _base_trainer(trainer):
    """Unwrap a ScheduledTrainer to the engine trainer that owns the
    counters, ledger and plan."""
    return getattr(trainer, "trainer", trainer)


def _captures(base) -> int:
    graphs = base.update_graphs
    return 0 if graphs is None else graphs.captures


def audit_run(trainer, rounds: Optional[int] = None, *,
              warmup: bool = True) -> AuditReport:
    """Run ``rounds`` through ``trainer`` and reconcile against its plan.

    ``trainer`` is a ``FederatedTrainer`` or a ``ScheduledTrainer``; the
    audited counters live on the engine trainer.  With ``warmup``
    (default) one round (one chunk on the fused executor) runs first, and
    one more if an update graph was warmed but not captured, so that the
    audited window measures steady state and the recapture check means
    something.
    """
    from repro_torch.rlhf import sampling
    base = _base_trainer(trainer)
    plan = base.plan
    chunk = plan.fused_chunks[0] if plan.executor == "fused" else 1
    if rounds is None:
        rounds = 2 * chunk
    if plan.executor == "fused" and rounds % chunk:
        raise ValueError(
            f"audit rounds ({rounds}) must be a multiple of the fused "
            f"chunk ({chunk}) so per-round dispatch counts are exact")

    if warmup:
        trainer.run(chunk)
        if base.update_graphs is not None and base.update_graphs.uncaptured():
            trainer.run(chunk)

    h0 = base.host_transfers
    c0 = _captures(base)
    dc0 = sampling.decode_captures
    up0, down0 = base.ledger.up_bytes, base.ledger.down_bytes
    n0 = len(base.history) if plan.policy == "sync" else None

    t0 = time.perf_counter()
    with jitwatch.record() as log:
        trainer.run(rounds)
    seconds = time.perf_counter() - t0

    # fedbuff counts aggregations, not engine rounds; normalise by what
    # the engine appended when it ran engine rounds
    ran = (len(base.history) - n0) if n0 is not None else rounds
    ran = max(ran, 1)
    strict = plan.policy == "sync"
    checks = [
        AuditCheck("dispatches_per_round", predicted_dispatches(plan),
                   log.call_count / ran, strict),
        AuditCheck("up_bytes_per_round", float(plan.up_bytes_per_round),
                   (base.ledger.up_bytes - up0) / ran, strict),
        AuditCheck("down_bytes_per_round",
                   float(plan.down_bytes_per_round),
                   (base.ledger.down_bytes - down0) / ran, strict),
        AuditCheck("recompiles_after_warmup", 0.0 if warmup else None,
                   float(_captures(base) - c0), warmup),
        AuditCheck("host_transfers_per_round", None,
                   (base.host_transfers - h0) / ran, False),
    ]
    return AuditReport(
        algorithm=plan.algorithm,
        executor=plan.executor,
        policy=plan.policy,
        uplink_codec=plan.spec.engine.uplink_codec,
        downlink_codec=plan.spec.engine.downlink_codec,
        rounds=rounds,
        checks=checks,
        jit_calls=log.call_count,
        compiles_by_name=log.compiles_by_name(),
        reference_dispatches_per_round=plan.dispatches_per_round,
        decode_captures_per_round=(sampling.decode_captures - dc0) / ran,
        launches_per_round={k: n / ran for k, n in log.launches.items()},
        seconds=seconds,
    )
