"""Aggregation policies behind one scheduler protocol (counterpart of
``repro.fed.sched.policies``).

``ScheduledTrainer`` puts an event-driven simulated clock over the round
engine: client system profiles (``profiles``) turn the engine's measured
payload bytes and each client's step count into simulated seconds
(``core.comms``' time models), and a policy decides when the server
aggregates:

  sync      every selected client reports before the round closes.  It
            runs ``FederatedTrainer.run_round`` (or, with
            ``EngineConfig.fused_rounds > 1``, ``FederatedTrainer.run``)
            unchanged and only adds timing, so rewards, lambda and bytes
            are the bare engine's bit for bit.  Round time: the slowest
            client.
  deadline  over-select participants (``SchedConfig.overselect``), predict
            each one's round time from the codecs' analytic bytes and its
            profile, drop those past the deadline, FedAvg the survivors
            (``run_round`` on them).  Round time: the deadline when anyone
            was dropped.
  fedbuff   buffered asynchrony: clients run continuously from the
            broadcast version they last received; the server aggregates
            every B arrivals with staleness weights w ~ (1+s)^-pow
            (``FederatedTrainer._aggregate_flat``) and dispatches the idle
            clients from the new version.  FIRM's regulariser beta scales
            with each client's observed staleness
            (``core.firm.staleness_beta``).  With B = C and homogeneous
            profiles every arrival has staleness 0 and the policy is sync
            FedAvg bit for bit.

Client work is computed eagerly at dispatch (its results depend on the
anchor and the random streams, never on the clock), and only simulated
durations go through the event queue, so a run is deterministic under a
seed.  A dispatch groups its clients by static config
(``cohort.build_cohorts``: the staleness-scaled beta of each bucket) and
runs each cohort's local phase through the trainer's own pieces
(``_broadcast``, ``_local_phase``, ``_delta_flat``, the uplink codec's
``roundtrip_flat``); beta rides the captured update's operands, so every
bucket replays one update graph on the card.  The arrivals' decoded rows
and rewards stay on the device until their aggregation, whose summary
takes one copy to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import SchedConfig
from repro_torch.core import comms, fedavg, firm
from repro_torch.fed import engine as engine_lib
from repro_torch.fed.sched.clock import EventQueue, SimClock
from repro_torch.fed.sched.cohort import build_cohorts
from repro_torch.fed.sched.profiles import sample_profiles
from repro_torch.obs import records as obs_records
from repro_torch.obs.trace import TraceBuilder


def client_round_seconds(profile, down_nbytes: float, up_nbytes: float,
                         local_steps: int, batch_size: int,
                         seq_len: int) -> float:
    """Download, local compute and upload, from bytes, tokens and rates.

    The sum of ``core.comms.client_round_segments``: one definition for
    the policies' timing and the trace's spans, so a client's spans add up
    to its reported round time."""
    return sum(d for _, d in comms.client_round_segments(
        profile, down_nbytes, up_nbytes, local_steps, batch_size,
        seq_len))


class SyncPolicy:
    """Synchronous barrier: the bare engine round and a max-over-clients
    clock advance, bit for bit the ``FederatedTrainer``'s results.

    With ``EngineConfig.fused_rounds > 1`` (and a trainer the fused
    executor can run) the whole horizon runs through
    ``FederatedTrainer.run``, in chunks of R rounds, and the clock
    annotates each summary afterwards: a chunk's bytes are the per-round
    path's, so the simulated durations are the same.  The deadline and
    fedbuff policies stay per round: they consult the clock between
    dispatches.
    """

    name = "sync"

    def run(self, st: "ScheduledTrainer", rounds: int) -> List[dict]:
        tr = st.trainer
        if tr.ec.fused_rounds > 1 and tr._fused_mode()[0]:
            start = len(tr.history)
            tr.run(rounds)
            return [self._annotate(st, s, round_idx=start + i)
                    for i, s in enumerate(tr.history[start:])]
        return [self.step(st) for _ in range(rounds)]

    def step(self, st: "ScheduledTrainer") -> dict:
        s = st.trainer.run_round()
        return self._annotate(st, s,
                              round_idx=len(st.trainer.history) - 1)

    def _annotate(self, st: "ScheduledTrainer", s: dict,
                  round_idx: Optional[int] = None) -> dict:
        t0 = st.clock.now
        segs = [st.client_segments(c, s["down_nbytes"], s["up_nbytes"][i],
                                   s["local_steps"][i])
                for i, c in enumerate(s["participants"])]
        durs = [sum(d for _, d in seg) for seg in segs]
        dur = max(durs)
        for c, seg in zip(s["participants"], segs):
            st.trace.client_span(c, t0, seg, round_idx=round_idx)
        st.trace.server_span("round", t0, dur,
                             {"policy": self.name, "round": round_idx,
                              "participants": len(durs)})
        st.clock.advance_by(dur)
        st.trace.instant("aggregate", st.clock.now,
                         args={"round": round_idx})
        obs_records.annotate_schedule(
            s, policy=self.name, sim_time=st.clock.now,
            round_duration=dur, dropped=[], client_seconds=durs)
        st.obs.emit_schedule(s, round=round_idx)
        return s


class DeadlinePolicy:
    """Over-select, predict, drop stragglers, FedAvg the survivors.

    Predictions use the codecs' analytic byte model (what a scheduler
    knows before the round); measured bytes time the survivors after the
    fact.  overselect=1 with an infinite deadline selects and keeps exactly
    the sync participants.
    """

    name = "deadline"

    def run(self, st: "ScheduledTrainer", rounds: int) -> List[dict]:
        return [self.step(st) for _ in range(rounds)]

    def step(self, st: "ScheduledTrainer") -> dict:
        tr, sc = st.trainer, st.sc
        fc = tr.fc
        target = max(1, int(round(fc.participation * fc.n_clients)))
        n_sel = min(fc.n_clients,
                    max(target, int(round(sc.overselect * target))))
        selected = tr._sample_participants(n=n_sel)
        d = tr.d_trainable
        up_pred = comms.codec_bytes_per_param(tr.ec.uplink_codec, d) * d
        down_pred = comms.codec_bytes_per_param(tr.ec.downlink_codec, d) * d
        pred = {c: st.client_seconds(c, down_pred, up_pred,
                                     tr._client_fcs[c].local_steps)
                for c in selected}
        deadline = sc.deadline_s
        if sc.deadline_quantile is not None:
            deadline = float(np.quantile(list(pred.values()),
                                         sc.deadline_quantile))
        survivors = [c for c in selected if pred[c] <= deadline]
        if not survivors:                 # never stall: keep the fastest
            survivors = [min(selected, key=lambda c: pred[c])]
        dropped = [c for c in selected if c not in survivors]

        t0 = st.clock.now
        s = tr.run_round(participants=survivors)
        round_idx = len(tr.history) - 1
        if dropped:
            # dropped clients were dispatched and received the broadcast
            # before missing the deadline: their downlink bytes are spent,
            # only their uploads never land
            tr.ledger.down_bytes += len(dropped) * s["down_nbytes"]
            s["down_bytes"] = tr.ledger.down_bytes
            s["comm_bytes"] = tr.ledger.total
        segs = [st.client_segments(c, s["down_nbytes"], s["up_nbytes"][i],
                                   s["local_steps"][i])
                for i, c in enumerate(survivors)]
        durs = [sum(d for _, d in seg) for seg in segs]
        # the server holds the barrier open until the deadline whenever
        # anyone was dropped (it cannot know they will not make it)
        dur = max(durs) if not dropped else max(max(durs), deadline)
        for c, seg in zip(survivors, segs):
            st.trace.client_span(c, t0, seg, round_idx=round_idx)
        for c in dropped:
            # spans from the scheduler's own prediction (analytic bytes):
            # the work was dispatched, the upload never landed
            st.trace.client_span(
                c, t0,
                st.client_segments(c, down_pred, up_pred,
                                   tr._client_fcs[c].local_steps),
                round_idx=round_idx, extra={"dropped": True})
            st.trace.instant("deadline missed", t0 + deadline, client=c,
                             args={"predicted_seconds": round(pred[c], 6)})
        st.trace.server_span("round (deadline)", t0, dur,
                             {"policy": self.name, "round": round_idx,
                              "deadline": deadline,
                              "dropped": len(dropped)})
        st.clock.advance_by(dur)
        st.trace.instant("aggregate", st.clock.now,
                         args={"round": round_idx})
        obs_records.annotate_schedule(
            s, policy=self.name, sim_time=st.clock.now,
            round_duration=dur, dropped=dropped, client_seconds=durs,
            selected=selected, deadline=deadline)
        st.obs.emit_schedule(s, round=round_idx)
        return s


@dataclasses.dataclass
class _Arrival:
    """One client upload in flight: what the server will see land."""
    client: int
    version: int                     # server version it trained from
    decoded: torch.Tensor            # (d,) delta as the server decodes it
    rewards: torch.Tensor            # (M,) client mean rewards this phase
    up_nbytes: int
    flow_id: int = 0                 # trace flow arrow: upload -> aggregate


class FedBuffPolicy:
    """Buffered asynchronous aggregation with staleness-weighted deltas
    and staleness-scaled in-client regularisation."""

    name = "fedbuff"

    def __init__(self) -> None:
        self._last_cohorts = 0
        # decoded broadcast of the current server version: the anchor the
        # aggregation applies deltas to (the engine round's choice, so
        # lossy downlinks keep fedbuff(B=C) == sync)
        self._anchor = None

    def run(self, st: "ScheduledTrainer", rounds: int) -> List[dict]:
        tr, sc = st.trainer, st.sc
        if tr.algorithm.caps.single_cohort_required:
            raise ValueError(
                "fedbuff needs a client-local algorithm; "
                f"{tr.algorithm.name} requires lock-step participants "
                "(per-step server exchange is inherently synchronous)")
        n = tr.fc.n_clients
        buf_size = sc.buffer_size or n
        if not 1 <= buf_size <= n:
            raise ValueError(f"buffer_size {buf_size} outside [1, {n}]")

        def tap(op, t, depth):
            # queue depth = uploads in flight; sampled at dispatch time
            # for pushes, at the arrival's own time for pops
            st.trace.counter("uploads in flight",
                             st.clock.now if op == "push" else t,
                             {"in_flight": depth})

        queue = EventQueue(tap=tap)
        version = 0
        last_staleness: Dict[int, int] = {c: 0 for c in range(n)}
        self._dispatch(st, list(range(n)), version, last_staleness, queue)
        buffer: List[_Arrival] = []
        history: List[dict] = []
        last_agg = st.clock.now
        while len(history) < rounds and queue:
            ev = queue.pop()
            st.clock.advance_to(ev.time)
            buffer.append(ev.item)
            if len(buffer) < buf_size:
                continue
            staleness = [version - a.version for a in buffer]
            flats = torch.stack([a.decoded for a in buffer])
            tr.global_trainable = tr._aggregate_flat(
                self._anchor, flats, staleness, sc.staleness_pow)
            version += 1
            tr.ledger.next_round()
            for a, s_c in zip(buffer, staleness):
                last_staleness[a.client] = s_c
            # report the weights the aggregate applied (one formula)
            w = fedavg.staleness_weights(
                torch.as_tensor(staleness, dtype=torch.float32),
                sc.staleness_pow).numpy()
            # the aggregation's one copy to the host
            rewards_pc = engine_lib._to_host(torch.stack([a.rewards for a in buffer]))
            summary = obs_records.fedbuff_summary(
                version=version,
                sim_time=st.clock.now,
                round_duration=st.clock.now - last_agg,
                participants=[a.client for a in buffer],
                staleness=staleness,
                staleness_weights=w,
                rewards=rewards_pc.mean(0),
                rewards_per_client=rewards_pc,
                comm_bytes=tr.ledger.total,
                up_bytes=tr.ledger.up_bytes,
                down_bytes=tr.ledger.down_bytes,
            )
            st.trace.server_span(f"buffer v{version}", last_agg,
                                 st.clock.now - last_agg,
                                 {"policy": self.name,
                                  "arrivals": len(buffer)})
            st.trace.instant(f"aggregate v{version}", st.clock.now,
                             args={"staleness": staleness})
            for a, s_c in zip(buffer, staleness):
                st.trace.flow_end("upload", st.clock.now, a.flow_id,
                                  args={"client": a.client,
                                        "staleness": s_c})
            st.obs.emit_round(summary, round=version - 1)
            last_agg = st.clock.now
            idle = [a.client for a in buffer]
            buffer = []
            history.append(summary)
            if len(history) < rounds:
                # idle clients restart from the new version; skipped after
                # the last aggregation so that no discarded work runs
                self._dispatch(st, idle, version, last_staleness, queue)
                summary["cohorts"] = self._last_cohorts
            else:
                summary["cohorts"] = 0
        return history

    def _dispatch(self, st: "ScheduledTrainer", clients: List[int],
                  version: int, last_staleness: Dict[int, int],
                  queue: EventQueue) -> None:
        """Broadcast the current version to ``clients``, run their local
        phases now (a cohort's at a time), encode their uplinks and
        schedule the arrivals."""
        tr, sc = st.trainer, st.sc
        dl_payload, broadcast = tr._broadcast()
        self._anchor = broadcast
        down_nbytes = comms.measured_bytes(dl_payload)
        for _ in clients:
            tr.ledger.send_down(dl_payload)
        # each client's config with its staleness-scaled beta, bucketed so
        # that a few static configs cover every staleness level
        pairs = []
        for c in clients:
            base = tr._client_fcs[c]
            bucket = min(int(last_staleness[c]), sc.staleness_bucket_max)
            beta = firm.staleness_beta(base.beta, bucket,
                                       sc.staleness_beta_gain,
                                       sc.staleness_beta_cap)
            pairs.append((c, dataclasses.replace(base, beta=beta)))
        plan = build_cohorts(pairs,
                             lift_preference=tr._stacked_pref is not None)
        self._last_cohorts = len(plan)
        for co in plan:
            members = list(co.members)
            res = tr._local_phase(members, broadcast, cfc=co.cfc)
            flats = tr._delta_flat(res.stacked_trainable, broadcast)
            for i, c in enumerate(members):
                payload, tr._uplink_state[c], dec = \
                    tr.uplink_codec.roundtrip_flat(
                        flats[i], tr._delta_spec, tr._uplink_state[c],
                        key=tr._next_key())
                tr.ledger.send_up(payload)
                segs = st.client_segments(c, down_nbytes, payload.nbytes,
                                          co.cfc.local_steps)
                dur = sum(d for _, d in segs)
                t_end = st.trace.client_span(c, st.clock.now, segs,
                                             extra={"version": version})
                fid = st.trace.flow_start("upload", t_end, client=c,
                                          args={"version": version})
                queue.push(st.clock.now + dur,
                           _Arrival(c, version, dec, res.rewards_pc[i],
                                    int(payload.nbytes), fid))


_POLICIES = {"sync": SyncPolicy, "deadline": DeadlinePolicy,
             "fedbuff": FedBuffPolicy}


def make_policy(name: str):
    if name not in _POLICIES:
        raise ValueError(f"unknown scheduler policy {name!r}; "
                         f"available: {tuple(sorted(_POLICIES))}")
    return _POLICIES[name]()


class ScheduledTrainer:
    """Simulated-time federation: a FederatedTrainer, client profiles and
    an aggregation policy on an event-driven clock.

        tr = FederatedTrainer(cfg, fc, ec, device="cpu")
        st = ScheduledTrainer(tr, SchedConfig(policy="deadline",
                                              profile="bimodal",
                                              deadline_quantile=0.7))
        history = st.run(rounds)     # entries carry sim_time etc.

    One history entry per server aggregation.  The trainer is shared
    mutable state: do not reuse it across ScheduledTrainers.
    """

    def __init__(self, trainer, sc: Optional[SchedConfig] = None):
        self.trainer = trainer
        self.sc = SchedConfig() if sc is None else sc
        self.profiles = sample_profiles(trainer.fc.n_clients,
                                        self.sc.profile,
                                        self.sc.profile_seed)
        self.clock = SimClock()
        self.policy = make_policy(self.sc.policy)
        self.history: List[dict] = []
        # round records ride the engine's pipeline; the policies also feed
        # the simulated-time trace (client phase spans, aggregation
        # instants, drop and staleness annotations)
        self.obs = trainer.obs
        self.trace = TraceBuilder()
        # a trainer built without this SchedConfig planned itself without
        # it: plan again, so that trainer.plan is the policy's (deadline
        # and fedbuff run per round where the bare engine would fuse).  An
        # algorithm x policy pair plan() rejects raises from run() (the
        # construction succeeds, as the reference's does).
        if trainer.plan.spec.sched is not self.sc:
            from repro_torch.fed import api
            try:
                trainer.plan = api.plan(
                    api.RunSpec(model=trainer.cfg, firm=trainer.fc,
                                engine=trainer.ec, sched=self.sc),
                    d_trainable=trainer.d_trainable)
            except ValueError:
                pass

    def client_seconds(self, c: int, down_nbytes: float, up_nbytes: float,
                       local_steps: int) -> float:
        seq = self.trainer.ec.prompt_len + self.trainer.ec.max_new
        return client_round_seconds(self.profiles[c], down_nbytes,
                                    up_nbytes, local_steps,
                                    self.trainer.fc.batch_size, seq)

    def client_segments(self, c: int, down_nbytes: float,
                        up_nbytes: float, local_steps: int):
        """(phase, seconds) decomposition of ``client_seconds``: what the
        trace renders as consecutive spans."""
        seq = self.trainer.ec.prompt_len + self.trainer.ec.max_new
        return comms.client_round_segments(self.profiles[c], down_nbytes,
                                           up_nbytes, local_steps,
                                           self.trainer.fc.batch_size, seq)

    def run(self, rounds: Optional[int] = None) -> List[dict]:
        out = self.policy.run(self, rounds or self.trainer.fc.rounds)
        self.history.extend(out)
        return self.history

    def export_trace(self, path: str, host_spans=None) -> dict:
        """Write the schedule so far as Chrome/Perfetto trace-event JSON
        (open at https://ui.perfetto.dev).  ``host_spans`` optionally adds
        host wall-clock spans (``TraceBuilder.add_host_spans``).  Validates
        before writing; returns the trace dict."""
        if host_spans:
            self.trace.add_host_spans(host_spans)
        return self.trace.write(path)
