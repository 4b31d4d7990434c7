"""The port's scheduler (``fed/sched``: the clock, the profiles, the sync,
deadline and fedbuff policies and ``ScheduledTrainer``) and the beta
operand of the captured update, on the CPU at a tiny size (the llama of
``tests/test_sched.py``: 2 layers, d_model 64, vocab 256; B = 2, P = 4,
6 new tokens).

* the cases of ``tests/test_sched.py`` (the clock, the queue, the
  profiles, the staleness primitives, the participation stream, the
  policies' anchors, the bimodal runs, the errors) against the port;
* the clock, the queue and the profiles equal the reference's exactly;
* sync is the port's bare engine bit for bit, fedbuff with B = C at zero
  staleness is sync (identity and int8 downlinks), deadline with an
  infinite deadline is sync;
* against the JAX ``ScheduledTrainer``: for sync, deadline (C = 4, all
  four selected), fedbuff (C = 4, B = 2, bimodal seed 1: the fast pair
  fills every buffer) and a stale fedbuff (uniform seed 0: staleness 1
  and 2, two beta buckets in one dispatch), every schedule field and the
  trace dict exactly: they depend only on bytes and profiles;
* numbers under staleness: the port's ``_aggregate_flat`` against the
  JAX's at staleness (0, 2, 5) within 1e-6, and one ``firm_local_step``
  at a ``staleness_beta`` beta through the update runner against JAX's
  within ``tests/test_torch_training.py``'s tolerances;
* the beta operand: ``mgda.regularize`` with beta as a 0-d f32 tensor is
  the Python-float formula bit for bit, and updates of different beta
  (and ``firm_unreg``'s) replay one graph, each its eager update bit for
  bit;
* ``plan(RunSpec(sched=...)).build(device="cpu")`` for the golden plans
  ``firm_deadline`` and ``firm_fedbuff_int8ef`` runs.
"""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comms import codec as jcodec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.configs.base import SchedConfig as JSchedConfig  # noqa: E402
from repro.fed import engine as jengine  # noqa: E402
from repro.fed.sched import clock as jclock  # noqa: E402
from repro.fed.sched import profiles as jprofiles  # noqa: E402
from repro.fed.sched.policies import ScheduledTrainer as JScheduled  # noqa
from repro.models import common as jcommon  # noqa: E402
from repro.rlhf import local as jlocal  # noqa: E402
from repro_torch import trees  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.configs.base import SchedConfig  # noqa: E402
from repro_torch.core import fedavg, firm, mgda  # noqa: E402
from repro_torch.fed import algorithms, api  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.fed.sched import (EventQueue, ScheduledTrainer,  # noqa
                                   SimClock, sample_profiles)
from repro_torch.fed.sched import clock, profiles  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.rlhf import update_graph  # noqa: E402
from test_torch_plan import _matrix_spec  # noqa: E402
from test_torch_update_graph import (  # noqa: E402
    TOL, _batches, _client, _fcs, _np, _same, _setup, _StandInGraph,
    _states, _step, assert_close, assert_trees_close)

# the fields a schedule is made of (summary keys a policy sets from bytes
# and profiles), held equal to the JAX scheduler's
SCHEDULE_FIELDS = ("participants", "dropped", "staleness",
                   "staleness_weights", "version", "sim_time",
                   "round_duration", "client_seconds", "comm_bytes",
                   "up_bytes", "down_bytes", "policy", "selected",
                   "deadline", "up_nbytes", "down_nbytes", "local_steps",
                   "cohorts")


def _cfg(port=True):
    return (get_config if port else jget_config)("llama-3.2-1b").reduced(
        n_layers=2, d_model=64, vocab=256)


def _trainer(n_clients=2, local_steps=1, seed=0, port=True, **kw):
    fc_kw = {k: kw.pop(k) for k in ("client_local_steps", "participation",
                                    "client_preferences") if k in kw}
    fc = (FIRMConfig if port else JFIRMConfig)(
        n_objectives=2, n_clients=n_clients, local_steps=local_steps,
        batch_size=2, beta=0.05, **fc_kw)
    if not port:
        return jengine.FederatedTrainer(_cfg(False), fc, jengine.EngineConfig(
            max_new=6, prompt_len=4, seed=seed, **kw))
    ec = EngineConfig(max_new=6, prompt_len=4, seed=seed, **kw)
    return FederatedTrainer(_cfg(), fc, ec, device="cpu")


def _assert_trees_equal(t0, t1):
    for a, b in zip(trees.tree_leaves(t0), trees.tree_leaves(t1),
                    strict=True):
        assert torch.equal(a, b)


# ------------------------------------------------------- clock / queue
def test_event_queue_deterministic_tie_break():
    q = EventQueue()
    q.push(1.0, "b")
    q.push(0.5, "a")
    q.push(1.0, "c")                      # same time as "b": seq decides
    assert [q.pop().item for _ in range(3)] == ["a", "b", "c"]


def test_sim_clock_monotone():
    clk = SimClock()
    clk.advance_to(2.0)
    clk.advance_by(1.5)
    assert clk.now == 3.5
    with pytest.raises(ValueError):
        clk.advance_to(1.0)
    with pytest.raises(ValueError):
        clk.advance_by(-1.0)


def test_clock_and_queue_are_the_references():
    """The same pushes, pops, taps and advances on both sides give the
    same events, taps and times."""
    rng = np.random.default_rng(0)
    times = [float(t) for t in rng.choice([0.5, 1.0, 1.5, 2.0], 12)]
    out = []
    for mod in (clock, jclock):
        taps = []
        q = mod.EventQueue(tap=lambda *a, taps=taps: taps.append(a))
        clk = mod.SimClock()
        events = []
        for i, t in enumerate(times):
            q.push(t, i)
            if i % 3 == 2:
                ev = q.pop()
                try:
                    clk.advance_to(ev.time)
                except ValueError as e:         # an earlier time than now
                    events.append(str(e))
                events.append((ev.time, ev.seq, ev.item, clk.now,
                               q.peek_time(), len(q), bool(q)))
        clk.advance_by(0.25)
        while q:
            ev = q.pop()
            events.append((ev.time, ev.seq, ev.item))
        out.append((events, taps, clk.now))
    assert out[0] == out[1]
    assert any(isinstance(e, str) for e in out[0][0])


# ---------------------------------------------------------- profiles
def test_profiles_deterministic_and_presets():
    for preset in ("homogeneous", "uniform", "lognormal", "bimodal"):
        p0 = sample_profiles(8, preset, seed=3)
        assert p0 == sample_profiles(8, preset, seed=3)
        assert all(p.tokens_per_sec > 0 and p.up_bytes_per_sec > 0
                   for p in p0)
    assert len(set(sample_profiles(16, "bimodal", seed=0))) == 2
    with pytest.raises(ValueError):
        sample_profiles(4, "warp-speed")


@pytest.mark.parametrize("preset", sorted(profiles.PROFILE_PRESETS))
def test_profiles_are_the_references(preset):
    assert sorted(profiles.PROFILE_PRESETS) == sorted(
        jprofiles.PROFILE_PRESETS)
    for n, seed in itertools.product((1, 4, 16), (0, 1, 7)):
        got = profiles.sample_profiles(n, preset, seed)
        want = jprofiles.sample_profiles(n, preset, seed)
        assert [dataclasses.astuple(p) for p in got] == [
            dataclasses.astuple(p) for p in want]


# ------------------------------------------------ staleness primitives
def test_staleness_weights_sum_to_one_and_discount():
    w = fedavg.staleness_weights([0, 1, 5], pow=0.5).numpy()
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-6)
    assert w[0] > w[1] > w[2]
    # zero staleness: exactly uniform (sync FedAvg's weights)
    assert (fedavg.staleness_weights([0, 0, 0, 0]).numpy() == 0.25).all()


def test_staleness_beta_hook():
    assert firm.staleness_beta(0.05, 0, gain=1.0) == pytest.approx(0.05)
    assert firm.staleness_beta(0.05, 3, gain=1.0) == pytest.approx(0.2)
    assert firm.staleness_beta(0.05, 100, gain=1.0, cap=4.0) == \
        pytest.approx(0.2)
    assert firm.staleness_beta(0.05, 7, gain=0.0) == pytest.approx(0.05)


# ------------------------------------------------- named participant draw
def test_participation_stream_independent_of_main_rng():
    """The participant draw does not move when the main stream is read,
    and the deadline policy's over-selection reads the same stream: the
    draw with today's count is today's draw, and a larger one keeps its
    clients."""
    tr = _trainer(n_clients=8, participation=0.5)
    p0 = tr._sample_participants()
    for _ in range(7):
        tr._next_key()
    assert tr._sample_participants() == p0
    tr2 = _trainer(n_clients=8, participation=0.5)
    assert tr2._sample_participants(round_idx=0) == p0
    assert tr2._sample_participants(n=4) == p0
    p6 = tr2._sample_participants(n=6)
    assert p6 == tr._sample_participants(n=6) and set(p0) <= set(p6)
    assert len(p6) == 6 and p6 == sorted(p6)
    assert tr2._sample_participants(n=8) == list(range(8))
    assert tr2._sample_participants(n=3, round_idx=1) == \
        tr._sample_participants(n=3, round_idx=1)


# ---------------------------------------------- the policies' anchors
def test_sync_policy_bit_identical_to_engine():
    """Every summary key the engine writes, and the global adapters."""
    bare = _trainer(uplink_codec="int8+ef")
    s_eng = bare.run(2)
    st = ScheduledTrainer(_trainer(uplink_codec="int8+ef"),
                          SchedConfig(policy="sync", profile="bimodal"))
    s_sched = st.run(2)
    for a, b in zip(s_eng, s_sched, strict=True):
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), key)
    _assert_trees_equal(bare.global_trainable, st.trainer.global_trainable)
    assert s_sched[0]["round_duration"] > 0
    assert s_sched[1]["sim_time"] > s_sched[0]["sim_time"]


def test_sync_policy_fused_is_the_per_round_sync():
    """With fused_rounds = 2 the sync policy runs the horizon through the
    fused executor: the same schedule and results as per round."""
    hs = [ScheduledTrainer(_trainer(fused_rounds=r),
                           SchedConfig(policy="sync",
                                       profile="uniform")).run(2)
          for r in (1, 2)]
    for a, b in zip(*hs, strict=True):
        assert b["fused"] == 2
        for key in a:
            if key != "dispatches":
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]), key)


@pytest.mark.parametrize("downlink", ["identity", "int8"])
def test_fedbuff_zero_staleness_equals_sync_fedavg(downlink):
    """Homogeneous profiles and B = C: every arrival has staleness 0, the
    weights are uniform, and the run (per-client rewards, bytes, the
    aggregated adapters) is the sync barrier's bit for bit, under a lossy
    downlink too (the aggregate anchors on the decoded broadcast)."""
    sync = ScheduledTrainer(_trainer(downlink_codec=downlink),
                            SchedConfig(policy="sync"))
    hs = sync.run(2)
    fb = ScheduledTrainer(_trainer(downlink_codec=downlink),
                          SchedConfig(policy="fedbuff", buffer_size=2))
    hf = fb.run(2)
    for a, b in zip(hs, hf, strict=True):
        np.testing.assert_array_equal(a["rewards_per_client"],
                                      b["rewards_per_client"])
        assert b["staleness"] == [0, 0]
        assert b["staleness_weights"] == [0.5, 0.5]
        assert a["comm_bytes"] == b["comm_bytes"]
    _assert_trees_equal(sync.trainer.global_trainable,
                        fb.trainer.global_trainable)


def test_fedbuff_event_clock_deterministic():
    def run():
        return ScheduledTrainer(
            _trainer(n_clients=4),
            SchedConfig(policy="fedbuff", buffer_size=2, profile="bimodal",
                        staleness_beta_gain=1.0)).run(3)
    for a, b in zip(run(), run(), strict=True):
        assert a["sim_time"] == b["sim_time"]
        assert a["participants"] == b["participants"]
        assert a["staleness"] == b["staleness"]
        np.testing.assert_array_equal(a["rewards"], b["rewards"])


def test_fedbuff_bimodal_staleness_appears_and_trains():
    """Staleness > 0 appears, the beta coupling runs (two beta buckets
    replay one update graph), and a stale arrival's weight is
    discounted."""
    st = ScheduledTrainer(
        _trainer(n_clients=4),
        SchedConfig(policy="fedbuff", buffer_size=2, profile="bimodal",
                    staleness_beta_gain=1.0, staleness_bucket_max=2))
    st.trainer.update_graphs = update_graph.UpdateGraphs(_StandInGraph)
    h = st.run(4)
    assert max(max(e["staleness"]) for e in h) >= 1
    assert all(np.isfinite(e["rewards"]).all() for e in h)
    assert st.trainer.update_graphs.captures == 1
    mixed = ScheduledTrainer(
        _trainer(n_clients=4),
        SchedConfig(policy="fedbuff", buffer_size=2, profile="uniform",
                    staleness_beta_gain=1.0)).run(3)
    assert [e["cohorts"] for e in mixed] == [1, 2, 0]
    for e in h + mixed:
        if max(e["staleness"]) > min(e["staleness"]):
            ws = dict(zip(e["staleness"], e["staleness_weights"]))
            assert ws[max(ws)] < ws[min(ws)]


def test_deadline_infinite_equals_sync():
    sync = ScheduledTrainer(_trainer(n_clients=4, participation=0.5),
                            SchedConfig(policy="sync"))
    hs = sync.run(2)
    dl = ScheduledTrainer(
        _trainer(n_clients=4, participation=0.5),
        SchedConfig(policy="deadline", overselect=1.0,
                    deadline_s=float("inf")))
    hd = dl.run(2)
    for a, b in zip(hs, hd, strict=True):
        assert a["participants"] == b["participants"]
        assert b["dropped"] == []
        np.testing.assert_array_equal(a["rewards"], b["rewards"])
        np.testing.assert_array_equal(a["per_client_lam"],
                                      b["per_client_lam"])
        assert a["round_duration"] == b["round_duration"]
    _assert_trees_equal(sync.trainer.global_trainable,
                        dl.trainer.global_trainable)


def test_deadline_drops_stragglers_and_saves_wallclock():
    def mk():
        return _trainer(n_clients=8, seed=1)
    hs = ScheduledTrainer(mk(), SchedConfig(policy="sync",
                                            profile="bimodal")).run(2)
    hd = ScheduledTrainer(mk(), SchedConfig(
        policy="deadline", profile="bimodal",
        deadline_quantile=0.2)).run(2)
    assert sum(len(e["dropped"]) for e in hd) > 0
    assert hd[-1]["sim_time"] < hs[-1]["sim_time"]
    assert all(np.isfinite(e["rewards"]).all() for e in hd)
    # the dropped clients' broadcasts are on the ledger
    for r, e in enumerate(hd):
        assert e["down_bytes"] == sum(
            (len(x["participants"]) + len(x["dropped"])) * x["down_nbytes"]
            for x in hd[:r + 1])


def test_scheduler_rejects_unknown_policy_and_fedcmoo_fedbuff():
    with pytest.raises(ValueError, match="policy"):
        ScheduledTrainer(_trainer(), SchedConfig(policy="psychic"))
    st = ScheduledTrainer(_trainer(algorithm="fedcmoo"),
                          SchedConfig(policy="fedbuff"))
    with pytest.raises(ValueError, match="fedbuff needs a client-local "
                       "algorithm; fedcmoo requires lock-step"):
        st.run(1)


# ------------------------------------ against the JAX ScheduledTrainer
SCHED_CASES = {
    "sync": (2, 2, dict(policy="sync", profile="bimodal", profile_seed=1),
             {}),
    "deadline": (4, 2, dict(policy="deadline", profile="bimodal",
                            profile_seed=1, overselect=2.0,
                            deadline_quantile=0.2),
                 dict(participation=0.5)),
    "fedbuff": (4, 3, dict(policy="fedbuff", buffer_size=2,
                           profile="bimodal", profile_seed=1,
                           staleness_beta_gain=1.0), {}),
    "fedbuff stale": (4, 3, dict(policy="fedbuff", buffer_size=2,
                                 profile="uniform", profile_seed=0,
                                 staleness_beta_gain=1.0), {}),
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_schedule_and_trace_are_the_references(case):
    """Every schedule field and the trace dict, exactly: the schedule
    depends on bytes and profiles alone (the ``wan`` uplink's measured
    bytes are its static bytes on both sides)."""
    n, rounds, sc, kw = SCHED_CASES[case]
    port = ScheduledTrainer(_trainer(n, uplink_codec="int8+ef", **kw),
                            SchedConfig(**sc))
    ref = JScheduled(_trainer(n, uplink_codec="int8+ef", port=False, **kw),
                     JSchedConfig(**sc))
    got, want = port.run(rounds), ref.run(rounds)
    for g, w in zip(got, want, strict=True):
        keys = [k for k in SCHEDULE_FIELDS if k in w]
        assert [k for k in SCHEDULE_FIELDS if k in g] == keys
        for k in keys:
            assert g[k] == w[k], k
    assert port.trace.to_dict() == ref.trace.to_dict()
    if case == "deadline":
        assert [g["dropped"] for g in got] == [[0, 2], [0, 2]]
    if case == "fedbuff stale":
        assert [g["staleness"] for g in got] == [[0, 0], [1, 0], [2, 1]]


# ------------------------------------------ the numbers under staleness
def test_aggregate_flat_under_staleness_is_the_references():
    """The port's staleness-weighted FedAvg against the JAX engine's
    flat aggregate, on the same anchor and decoded rows."""
    tr = _trainer(n_clients=3)
    rng = np.random.default_rng(4)
    anchor = trees.tree_map(
        lambda t: torch.from_numpy(rng.normal(0, 1, t.shape).astype(
            np.float32)), tr.global_trainable)
    flats = rng.normal(0, 1e-2, (3, tr.d_trainable)).astype(np.float32)
    janchor = {k: jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                         v) for k, v in anchor.items()}
    _, jspec = jcodec.tree_to_flat(janchor)
    for staleness in ([0, 2, 5], [0, 0, 0]):
        got = tr._aggregate_flat(anchor, torch.from_numpy(flats),
                                 staleness, 0.5)
        want = jengine._jit_flat_aggregate(jspec)(
            janchor, jnp.asarray(flats), jnp.asarray(staleness, jnp.float32),
            jnp.float32(0.5))
        for g, w in zip(trees.tree_leaves(got),
                        jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)


def test_local_step_at_a_staleness_beta_is_the_references():
    """One ``firm_local_step`` at beta = staleness_beta(0.05, 2, 1.0)
    through the update runner (beta on its operands) against JAX's."""
    beta = firm.staleness_beta(0.05, 2, 1.0, 8.0)
    jcfg, tcfg, jp, tp = _setup("llama", "f32", seed=2)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    jfc, tfc = _fcs(beta=beta)
    js, ts = _states(jtrain, jcfg.d_model, seed=2)
    (jb, tb), = _batches(jcfg, jp, 1, seed=2)
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    alg = algorithms.get_algorithm("firm")
    for _ in range(2):        # warm, then capture and replay
        ts1, tm = alg.step(tcfg, tfc, ts, tfrozen, tb, None, None, graphs)
    js1, jm = jlocal.firm_local_step(jcfg, jfc, js, jfrozen, jb)
    for key in ("lam", "lam_star", "gram", "losses", "kl", "td_err",
                "grad_norm"):
        assert_close(tm[key], jm[key], TOL["f32"], key)
    assert_trees_close(ts1.opt.mu, js1.opt.mu, TOL["f32"], "mu")
    assert_close(ts1.critic["w"], js1.critic["w"], TOL["f32"], "critic")
    for n, o, jn, jo in zip(common.tree_leaves(ts1.trainable),
                            common.tree_leaves(ts.trainable),
                            jax.tree_util.tree_leaves(js1.trainable),
                            jax.tree_util.tree_leaves(js.trainable)):
        assert_close((n - o) / tfc.actor_lr,
                     (_np(jn) - _np(jo)) / jfc.actor_lr, 1e-2, "Adam step")
    assert graphs.captures == 1


# -------------------------------------------------- the beta operand
BETAS = sorted({0.0, 0.01, 0.05, 1 / 3, 0.7, 2.5} | {
    firm.staleness_beta(b, s, g, 8.0)
    for b, s, g in itertools.product((0.01, 0.05, 1 / 3), range(4),
                                     (0.5, 1.0))})


@pytest.mark.parametrize("trace_normalize", [True, False])
def test_regularize_with_a_beta_tensor_is_the_float_formula(
        trace_normalize):
    """``G + 0.5 * beta * I`` with beta a 0-d f32 tensor (what a captured
    update reads) is the Python-float formula bit for bit, and so is the
    solve."""
    rng = np.random.default_rng(0)
    for m, beta in itertools.product((2, 3, 4), BETAS):
        a = torch.from_numpy(rng.normal(0, 1, (m, 8)).astype(np.float32))
        G = a @ a.T
        Gn = (G / torch.clamp(torch.trace(G) / m, min=1e-12)
              if trace_normalize else G)
        old = Gn + 0.5 * beta * torch.eye(m, dtype=G.dtype)
        bt = firm.config_tensor(float(beta), torch.device("cpu"))
        for b in (beta, bt):
            assert torch.equal(mgda.regularize(G, b, None, trace_normalize),
                               old), (m, beta)
        assert torch.equal(
            mgda.solve(G, bt, trace_normalize=trace_normalize),
            mgda.solve(G, beta, trace_normalize=trace_normalize))


def test_updates_of_different_beta_replay_one_graph():
    """Two clients' updates at the staleness betas of buckets 0 and 2,
    and a ``firm_unreg`` update (beta pinned to 0), through one runner:
    one key, one capture, each update its eager update bit for bit."""
    tcfg, tfc, frozen, a, b, batches = _client("llama")
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    cases = [("firm", 0, a, 0), ("firm", 2, b, 1), ("firm", 2, a, 2),
             ("firm_unreg", 0, b, 0), ("firm", 1, a, 1)]
    for alg_name, bucket, state, k in cases:
        cfc = dataclasses.replace(tfc, beta=firm.staleness_beta(
            tfc.beta, bucket, 1.0, 8.0))
        want = _step(alg_name, tcfg, cfc, state, frozen, batches[k], None)
        got = _step(alg_name, tcfg, cfc, state, frozen, batches[k], graphs)
        assert _same(got, want), (alg_name, bucket)
    assert graphs.captures == 1 and len(graphs._entries) == 1
    (key,) = graphs._entries
    assert key[2].beta == 0.0


# ------------------------------------------------------ the front door
@pytest.mark.parametrize("name", ["firm_deadline", "firm_fedbuff_int8ef"])
def test_golden_sched_plans_build_a_scheduled_trainer(name):
    spec = _matrix_spec(name)
    p = api.plan(spec)
    st = p.build(device="cpu")
    assert isinstance(st, ScheduledTrainer) and st.trainer.plan is p
    assert st.sc is spec.sched and st.policy.name == spec.sched.policy
    (s,) = st.run(1)
    assert s["policy"] == spec.sched.policy and s["sim_time"] > 0
    assert np.isfinite(s["rewards"]).all()
    assert st.obs is st.trainer.obs
    assert len(st.obs.select("sched/sim_time")) == 1


def test_sync_trace_reconciles_and_exports(tmp_path):
    """The server track sums to the last ``sim_time``, each client's to
    its reported seconds; the sched records ride the engine's pipeline
    once a round; ``export_trace`` writes a valid file."""
    from repro_torch.obs import span_seconds_by_track, validate_trace
    st = ScheduledTrainer(_trainer(), SchedConfig(policy="sync",
                                                  profile="bimodal"))
    st.run(2)
    t = st.trace.to_dict()
    sums = span_seconds_by_track(t)
    assert sums[(1, 0)] == pytest.approx(st.history[-1]["sim_time"],
                                         rel=1e-9)
    for c in range(2):
        assert sums[(1, c + 1)] == pytest.approx(
            sum(h["client_seconds"][c] for h in st.history), abs=1e-5)
    assert len(st.obs.select("sched/sim_time")) == 2
    assert len(st.obs.select("round/kl")) == 2
    path = tmp_path / "sched.trace.json"
    assert st.export_trace(str(path)) == t
    validate_trace(t)
