"""Declarative run API: RunSpec -> plan() -> ExecutionPlan -> execute()
(counterpart of ``repro.fed.api``).

The front door to the federated engine.  A ``RunSpec`` names what to run
(model x FIRM hyperparameters x engine knobs x optional scheduler);
``plan()`` resolves algorithm x codec x scheduler policy x cohort
structure into an inspectable ``ExecutionPlan``: the chosen executor
(``loop`` / ``vectorized`` / ``fused``), fused chunking, the cohort plan,
the reference's dispatches a round and the exact wire bytes a round (from
the codecs' ``nbytes_static``), all before any parameter is allocated.
``execute(plan)`` (or ``plan.execute()``) builds the trainer and runs it.

    spec = RunSpec(model=cfg, firm=fc, engine=EngineConfig())
    p = plan(spec)
    p.executor            # "vectorized"
    p.up_bytes_per_round  # exact wire bytes, nothing allocated
    trainer = p.build(device="cuda")

Every executor decision is a capability query against the algorithm
registry (``fed.algorithms``); the planner and the trainer share
``resolve_local_mode`` and ``resolve_fused``, so the plan is what the
trainer does.  The decisions, reasons and byte predictions equal the
reference planner's for the same spec.  A ``fused`` plan runs through
the trainer's fused executor (``FederatedTrainer.run_rounds_fused``), in
the plan's ``fused_chunks``.  A plan with a scheduler (``spec.sched``)
builds a ``fed.sched.ScheduledTrainer`` around the trainer, whose policy
(``sync``, ``deadline``, ``fedbuff``) runs it on a simulated clock.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import trees
from repro_torch.comms import make_codec
from repro_torch.configs.base import FIRMConfig, ModelConfig, SchedConfig
from repro_torch.fed.algorithms import (Algorithm, Capabilities,
                                        client_configs, get_algorithm)
from repro_torch.fed.sched.cohort import build_cohorts, cohort_summaries

# the scheduler's policy names (``sched.policies._POLICIES``, which the
# planner does not import: the policies import the engine)
POLICIES = ("deadline", "fedbuff", "sync")


@dataclasses.dataclass
class EngineConfig:
    """Engine knobs orthogonal to the FIRM hyperparameters.

    ``algorithm`` names an entry of the registry (``fed.algorithms``);
    every execution-path knob (``vectorized_clients``, ``fused_rounds``)
    is a request the planner grants only when the algorithm's declared
    capabilities and the codecs allow it; see ``plan()``.
    """
    algorithm: str = "firm"
    prompt_len: int = 8
    max_new: int = 24
    dirichlet_alpha: float = 0.3
    seed: int = 0
    heterogeneous_rms: bool = False      # half the clients use the alt RM
    fedcmoo_compress_rank: Optional[int] = None   # fedcmoo sketch rank
    linear_weights: Optional[Sequence[float]] = None  # linear scalarization
    # comms codecs (repro_torch.comms registry specs, e.g. "int8+ef")
    uplink_codec: str = "identity"       # client -> server deltas/grads
    downlink_codec: str = "identity"     # server -> client broadcast
    # run the round's local phase as the vectorized executor's (one cohort
    # a static config); False asks for the per-client loop executor
    vectorized_clients: bool = True
    # fuse R rounds into one chunk with one copy to the host at its end
    # (the reference's round-level scan): FederatedTrainer.run_rounds_fused
    fused_rounds: int = 1
    # extra telemetry sinks (``obs.metrics.make_sink`` specs, e.g.
    # "jsonl:PATH,csv:PATH"); an in-memory sink is always attached
    metrics_sink: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything needed to plan and run one federated training job."""
    model: ModelConfig
    firm: FIRMConfig
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    sched: Optional[SchedConfig] = None   # None -> bare engine (no clock)
    rounds: Optional[int] = None          # None -> firm.rounds


# ------------------------------------------------------- shared resolution
def resolve_local_mode(algorithm: Algorithm,
                       client_fcs: Sequence[FIRMConfig],
                       participants: Sequence[int], *,
                       vectorized_clients: bool,
                       lift_preference: bool):
    """One round's local-phase path from capability queries alone.

    Returns ``(mode, cohort_plan, reason)`` with mode one of ``"vec"``
    (one cohort), ``"cohort"`` (one local phase a static-config group) or
    ``"loop"`` (the per-client loop).  Shared by the trainer (per round,
    actual participants) and the planner (full population).
    """
    if not vectorized_clients:
        return "loop", None, "vectorized_clients disabled by config"
    if not algorithm.caps.vmap_safe:
        return "loop", None, (f"{algorithm.name}: local step is not "
                              "vmap-safe")
    has = [client_fcs[c].preference is not None for c in participants]
    if any(has) and not all(has):
        return "loop", None, "mixed static/absent per-client preference"
    plan = build_cohorts([(c, client_fcs[c]) for c in participants],
                         lift_preference=lift_preference)
    if len(plan) == 1:
        return "vec", plan, "single static-config cohort"
    if algorithm.caps.single_cohort_required:
        return "loop", None, (
            f"{algorithm.name} requires a single cohort (lock-step "
            f"server exchange) but static configs diverge into "
            f"{len(plan)} groups")
    return "cohort", plan, f"{len(plan)} static-config cohorts"


def resolve_fused(algorithm: Algorithm, local_mode: str, uplink_codec,
                  downlink_codec):
    """May whole rounds ride the reference's round-level scan?  Returns
    ``(ok, reason)``."""
    if not algorithm.caps.fusable:
        return False, (f"{algorithm.name} is not fusable (its server "
                       "exchange is host-driven)")
    if local_mode != "vec":
        return False, ("fused rounds need the single-cohort vectorized "
                       f"path (local mode is {local_mode!r})")
    if not (getattr(uplink_codec, "traceable", False)
            and getattr(downlink_codec, "traceable", False)):
        return False, "codec does not support the traced contract"
    return True, ("single-cohort vectorized round body stages into the "
                  "round-level scan")


@functools.lru_cache(maxsize=None)
def trainable_size(cfg: ModelConfig) -> int:
    """d, the number of trainable parameters, without allocating them: the
    port's own tree built on the ``meta`` device (shapes only)."""
    from repro_torch.models import transformer
    from repro_torch.models.common import split_trainable
    shapes = transformer.init_params(cfg, generator=torch.Generator(),
                                     device="meta")
    trainable, _ = split_trainable(shapes)
    return int(trees.tree_size(trainable))


# ------------------------------------------------------------ the plan
@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The resolved execution strategy for one RunSpec: inspectable before
    anything is allocated, executable via ``execute()``."""
    spec: RunSpec
    algorithm: str
    capabilities: Capabilities
    policy: str                           # sync | deadline | fedbuff
    executor: str                         # loop | vectorized | fused
    local_mode: str                       # loop | vec | cohort
    cohorts: Tuple[Tuple[int, int], ...]  # (n_members, local_steps) each
    n_clients: int
    participants_per_round: int
    rounds: int
    fused_chunks: Tuple[int, ...]         # () unless executor == "fused"
    dispatches_per_round: float
    d_trainable: int
    up_bytes_per_round: int
    down_bytes_per_round: int
    reasons: Tuple[str, ...]

    def summary(self) -> dict:
        """JSON-able snapshot, key for key the reference's."""
        ec = self.spec.engine
        return {
            "algorithm": self.algorithm,
            "capabilities": dataclasses.asdict(self.capabilities),
            "policy": self.policy,
            "executor": self.executor,
            "local_mode": self.local_mode,
            "cohorts": [list(c) for c in self.cohorts],
            "n_clients": self.n_clients,
            "participants_per_round": self.participants_per_round,
            "rounds": self.rounds,
            "fused_chunks": list(self.fused_chunks),
            "dispatches_per_round": round(self.dispatches_per_round, 3),
            "uplink_codec": ec.uplink_codec,
            "downlink_codec": ec.downlink_codec,
            "d_trainable": self.d_trainable,
            "up_bytes_per_round": self.up_bytes_per_round,
            "down_bytes_per_round": self.down_bytes_per_round,
            "reasons": list(self.reasons),
        }

    def build(self, device=None, params=None):
        """The trainer this plan describes, on ``device`` (``cuda`` unless
        the caller asks for the CPU); parameters are allocated here (from
        ``params`` if given), never at plan time.  With a scheduler, the
        trainer inside a ``ScheduledTrainer``."""
        from repro_torch.fed.engine import FederatedTrainer
        tr = FederatedTrainer(self.spec.model, self.spec.firm,
                              self.spec.engine, plan=self, params=params,
                              device=device)
        if self.spec.sched is None:
            return tr
        from repro_torch.fed.sched.policies import ScheduledTrainer
        return ScheduledTrainer(tr, self.spec.sched)

    def execute(self, rounds: Optional[int] = None, device=None
                ) -> List[dict]:
        """build + run; returns the run history."""
        return self.build(device=device).run(rounds or self.rounds)


def _dispatch_estimate(algorithm: Algorithm, executor: str,
                       local_mode: str, cohorts, client_fcs,
                       n_part: int, chunk: int) -> float:
    """The reference engine's jitted dispatches a round.  Participant
    subsets are approximated by the population-mean local-step count."""
    mean_k = sum(fc.local_steps for fc in client_fcs) / len(client_fcs)
    if executor == "fused":
        return 3.0 / chunk                 # stack + fused scan + unstack
    if executor == "loop" or local_mode == "loop":
        return (algorithm.loop_dispatches_per_client_step * n_part * mean_k
                + 4)                       # stack, delta, aggregate, summary
    if local_mode == "cohort":
        return 3 * len(cohorts) + 4        # 3 per cohort + concat + 3
    k = max(fc.local_steps for fc in client_fcs)
    return 2 + algorithm.vec_phase_dispatches(k) + 3


def plan(spec: RunSpec, d_trainable: Optional[int] = None
         ) -> ExecutionPlan:
    """Resolve a RunSpec into an ExecutionPlan via capability queries.

    Raises the errors execution would (unknown algorithm or policy,
    capability violations such as fedcmoo x heterogeneous local steps or
    fedcmoo x fedbuff) before anything is allocated."""
    fc, ec = spec.firm, spec.engine
    alg = get_algorithm(ec.algorithm)
    alg.validate(fc, ec)
    reasons: List[str] = []

    policy = spec.sched.policy if spec.sched is not None else "sync"
    if policy not in POLICIES:
        raise ValueError(f"unknown scheduler policy {policy!r}; "
                         f"available: {POLICIES}")
    if policy == "fedbuff" and alg.caps.single_cohort_required:
        raise ValueError(
            f"fedbuff needs a client-local algorithm; {alg.name} "
            "requires lock-step participants (per-step server exchange)")

    cfcs = client_configs(alg, fc)
    lift = fc.client_preferences is not None
    mode, cohort_plan, mode_reason = resolve_local_mode(
        alg, cfcs, range(fc.n_clients),
        vectorized_clients=ec.vectorized_clients, lift_preference=lift)
    reasons.append(f"local phase: {mode} ({mode_reason})")

    ul = make_codec(ec.uplink_codec)
    dl = make_codec(ec.downlink_codec)
    fused_ok, fused_reason = resolve_fused(alg, mode, ul, dl)
    chunk = max(1, int(ec.fused_rounds))
    if chunk <= 1:
        fused_ok = False
        fused_reason = "fused_rounds <= 1"
    if fused_ok and policy != "sync":
        fused_ok = False
        fused_reason = (f"{policy} policy consults the clock between "
                        "dispatches (host-driven round control)")
    reasons.append(f"fused: {'yes' if fused_ok else 'no'} "
                   f"({fused_reason})")

    executor = ("fused" if fused_ok
                else "loop" if mode == "loop" else "vectorized")

    rounds = spec.rounds or fc.rounds
    fused_chunks: Tuple[int, ...] = ()
    if executor == "fused":
        full, tail = divmod(rounds, chunk)
        fused_chunks = (chunk,) * full + ((tail,) if tail else ())

    d = (trainable_size(spec.model) if d_trainable is None
         else int(d_trainable))
    n_part = min(fc.n_clients,
                 max(1, int(round(fc.participation * fc.n_clients))))
    up = n_part * alg.uplink_bytes_per_participant(fc, ul, d)
    down = n_part * dl.nbytes_static(d)
    cohorts = cohort_summaries(cohort_plan) if cohort_plan else ()

    return ExecutionPlan(
        spec=spec,
        algorithm=alg.name,
        capabilities=alg.caps,
        policy=policy,
        executor=executor,
        local_mode=mode,
        cohorts=cohorts,
        n_clients=fc.n_clients,
        participants_per_round=n_part,
        rounds=rounds,
        fused_chunks=fused_chunks,
        dispatches_per_round=_dispatch_estimate(
            alg, executor, mode, cohorts, cfcs, n_part, chunk),
        d_trainable=d,
        up_bytes_per_round=int(up),
        down_bytes_per_round=int(down),
        reasons=tuple(reasons),
    )


def execute(p: ExecutionPlan, rounds: Optional[int] = None,
            device=None) -> List[dict]:
    """Run an ExecutionPlan end to end; returns the history."""
    return p.execute(rounds, device=device)
