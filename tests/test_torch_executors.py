"""The port's loop executor and heterogeneous-K cohorts against the JAX
package's, on the CPU at a tiny size (the f32 llama of
``test_torch_round.py``: 2 layers, d_model 64, vocab 256; B = 2).

Each JAX trainer's state is carried into the port's trainer by
``bridge.load_trainer_state`` before round 1 (anchored), and round 2 runs
on the port's own state (carried).  Every JAX draw is replayed from the
JAX trainer's key in the order its round reads it (the helpers of
``test_torch_algorithm_rounds.py``, generalised to a K a client) and
handed to the port: the downlink key; the generation keys step-major over
the participants, skipping clients whose K is used up (for ``fedcmoo``,
per step, one generation key then M gradient-codec keys a participant,
then one lambda key); then P uplink keys.  With heterogeneous K the
injected prompt blocks and Gumbel noise are padded to the largest K.

Cases against the JAX package:

* the loop executor (``vectorized_clients=False``) against the JAX loop
  executor, C = 2, K = 2: ``firm`` under ``wan``, round 1 anchored and
  round 2 carried; ``linear`` under ``wan``, one round; ``fedcmoo`` with
  identity codecs (two rounds) and under ``wan`` (one round: each step's
  stacked gradient roundtrip held row by row, bit for bit, to the
  reference loop's per-gradient int8 codec on the port's input with the
  JAX key of the row);
* a round of cohorts (``client_local_steps=(1, 2, 1, 2)``, C = 4) against
  the JAX cohort round, round 1 anchored and round 2 carried, and one
  round at participation 0.5 given the reference's participants (two
  clients of unequal K: two cohorts): ``tests/test_torch_cohorts.py``,
  through ``run_cases`` and ``check_round`` here.

The JAX loop binds its reference logprobs to the reference model when it
is built; the f32 model put into it afterwards is bound again here.

Tolerances, those of ``test_torch_algorithm_rounds.py``: bytes,
participants, ``dispatches``, ``cohorts``, tokens and rewards exact; drift
within 1e-4 of its scale; KL within 1e-6 absolute; lambda within 1e-4 and
the steps (each client's delta and the global's move, over actor_lr)
within 1e-2 of their scale (at most 0.2% of the entries past it, each
within 0.25), lambda and the steps over min(1, D), D the curvature of the
MGDA problem solved (the clients' from the reference's own steps, or the
server's from a spy on its ``server_solve``); ``linear``'s lambda is its
weights, exactly.

On the port alone: the loop executor against the vectorized executor,
three rounds from the same seed, bit for bit on the adapters, the client
states and the residuals (the summaries' reductions may differ in the
last bit); heterogeneous K through the loop against cohorts, likewise;
``plan().execute()`` against ``FederatedTrainer(...).run()``; a fused
plan's run; and what ran into explicit errors before it was ported (a
scheduler, a metrics sink), which now runs.
"""
import dataclasses
import functools
from typing import NamedTuple, Optional

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comms import make_codec as jmake_codec  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.core import fedcmoo as jfedcmoo  # noqa: E402
from repro.data.partition import sample_prompt_block  # noqa: E402
from repro.fed import algorithms as jalg  # noqa: E402
from repro.fed import engine as jengine  # noqa: E402
from repro_torch import bridge, trees  # noqa: E402
from repro_torch.comms import make_codec  # noqa: E402
from repro_torch.configs import FIRMConfig  # noqa: E402
from repro_torch.configs.base import CODEC_PRESETS, SchedConfig  # noqa
from repro_torch.fed import api  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.fed.sched import ScheduledTrainer  # noqa: E402
from test_torch_algorithm_rounds import (  # noqa: E402
    B, M, MAX_NEW, P, STEP_TOL, _cfgs, _f32_model,
    _flat, _jit_one_client, _np, _server_curvature, _snapshot, _spy,
    _step_close, _summary_close, assert_close)


def _split(r):
    out = jax.random.split(r)
    return out[0], out[1]


def _round_draws(jtr, jcfg, steps, exchange=False, parts=None):
    """What the next JAX round will draw, replayed from its key (see the
    module docstring); ``steps`` is the participants' K, in order.
    Returns the port's injected draws (prompt blocks and Gumbel noise
    padded to the largest K) and the JAX keys and prompts, ``gen[k][i]``
    None where participant i has no step k."""
    parts = list(range(len(jtr.datasets))) if parts is None else parts
    n, k_max = len(parts), max(steps)
    rng, down = _split(jtr._rng)
    gen = [[None] * n for _ in range(k_max)]
    grad = [[] for _ in range(k_max)]
    for k in range(k_max):
        for i in range(n):
            if k < steps[i]:
                rng, gen[k][i] = _split(rng)
                for _ in range(M if exchange else 0):
                    rng, kk = _split(rng)
                    grad[k].append(kk)
        if exchange:
            rng, _ = _split(rng)                      # the lambda key
    up = []
    for _ in range(n):
        rng, kk = _split(rng)
        up.append(kk)
    idx = jnp.asarray(parts, jnp.int32)
    counts0 = jnp.asarray([jtr.datasets[c]._count for c in parts],
                          jnp.int32)
    prompts = np.stack([np.asarray(sample_prompt_block(
        jtr._seeds_all[idx], counts0 + k, jtr._probs_all[idx], B, P,
        jcfg.vocab)) for k in range(k_max)])          # (K, P, B, P)
    gumbel = np.zeros((k_max, n, MAX_NEW, B, jcfg.vocab), np.float32)
    for k in range(k_max):
        for i in range(n):
            if gen[k][i] is not None:
                gumbel[k, i] = np.stack([
                    np.asarray(jax.random.gumbel(s, (B, jcfg.vocab)))
                    for s in jax.random.split(gen[k][i], MAX_NEW)])
    rows = -(-jtr.d_trainable // 1024)

    def bits(kk):
        return np.asarray(jax.random.bits(kk, (rows, 1024), jnp.uint32)
                          ).view(np.int32)
    draws = {"prompts": torch.from_numpy(prompts).long(),
             "gumbel": torch.from_numpy(gumbel),
             "up_bits": torch.from_numpy(np.stack([bits(kk) for kk in up]))}
    if exchange:
        draws["grad_bits"] = torch.from_numpy(np.stack(
            [np.stack([bits(kk) for kk in grad[k]]) for k in range(k_max)]))
    return draws, {"prompts": prompts, "gen": gen, "up": up, "grad": grad,
                   "down": down}


def _client_curvature(jtr, one_client, start, jd, parts, steps, beta):
    """The smallest MGDA curvature D over the round's client-steps, from
    the reference's own steps (``one_client`` of its vectorized round, the
    same step its loop runs) run one participant at a time from the
    round's start, prompts and keys."""
    curv = []
    for i, c in enumerate(parts):
        st = jtr.client_states[c]._replace(trainable=start)
        for k in range(steps[i]):
            st, met = one_client(st, jnp.asarray(jd["prompts"][k, i]),
                                 jd["gen"][k][i], jtr._bands_h[c],
                                 jtr._bands_x[c], jtr.frozen, jtr.ref_params)
            if "gram" in met:
                g = np.asarray(met["gram"], np.float64)
                q = g / (np.trace(g) / M) + 0.5 * beta * np.eye(M)
                curv.append(q[0, 0] + q[1, 1] - 2 * q[0, 1])
    return float(min(curv)) if curv else None


class RoundCase(NamedTuple):
    name: str
    n_round: int
    got: dict
    want: dict
    slack: float                 # 1 / min(1, D)
    weights: Optional[tuple]     # linear's lambda
    up: str                      # the uplink spec
    jspec: object                # the JAX flat TreeSpec of a delta
    up_keys: list
    grad_keys: list              # per step, the JAX gradient-codec keys
    jbroadcast: np.ndarray
    tbroadcast: np.ndarray
    jdelta: np.ndarray           # (P, d) codec input of the delta uplink
    tdelta: tuple                # ((inputs, residuals in), outputs)
    tgrads: list                 # (rows in, outputs) per gradient stack
    jglobal: np.ndarray
    tglobal: np.ndarray
    carried_from: Optional[list]  # the port's residuals of the round before


def _run_case(name, algorithm, preset, n_rounds, *, n_clients=2, k=2,
              client_local_steps=None, participation=1.0, **ec_kw):
    """n_rounds rounds of one JAX trainer and one port trainer loaded from
    its snapshot before round 1, on the reference's participants; returns
    one RoundCase a round."""
    jcfg, tcfg = _cfgs()
    fields = dict(n_clients=n_clients, local_steps=k, batch_size=B,
                  n_objectives=M, client_local_steps=client_local_steps,
                  participation=participation)
    jfc = dataclasses.replace(JFIRMConfig(), **fields)
    tfc = dataclasses.replace(FIRMConfig(), **fields)
    up, down = CODEC_PRESETS[preset]
    common_kw = dict(algorithm=algorithm, prompt_len=P, max_new=MAX_NEW,
                     uplink_codec=up, downlink_codec=down, **ec_kw)
    jtr = jengine.FederatedTrainer(jcfg, jfc,
                                   jengine.EngineConfig(**common_kw))
    params = bridge.to_torch(jax.tree_util.tree_map(
        np.asarray, _f32_model(jtr)), device="cpu")
    # the JAX loop's reference logprobs are bound to the reference model
    # at construction: bind them to the f32 one too
    jtr._jit_ref_lp = functools.partial(jengine._jit_ref_logprobs(jcfg),
                                        jtr.ref_params)
    ttr = api.plan(api.RunSpec(tcfg, tfc, EngineConfig(**common_kw))).build(
        device="cpu", params=params)
    bridge.load_trainer_state(ttr, _snapshot(jtr))
    exchange = not ttr.algorithm.caps.traced_server_exchange
    jfc_res = jalg.get_algorithm(algorithm).resolve_config(jfc)
    weights = (tuple(ec_kw.get("linear_weights") or (0.5, 0.5))
               if algorithm == "linear" else None)
    # the clients' MGDA curvature: fedcmoo's comes from the server's solve,
    # and linear solves no MGDA problem (its lambda is its weights)
    one_client = (None if exchange or weights is not None else
                  _jit_one_client(jcfg, jfc_res))
    logs = {"jd": [], "td": [], "tg": [], "tb": [], "server": []}
    _spy(ttr, "_broadcast", logs["tb"], lambda a: None)
    _spy(jtr.uplink_codec, "roundtrip_stacked", logs["jd"],
         lambda a: np.asarray(a[0]))

    def spy_stacked(codec):
        """The port's stacked roundtrips through ``codec``: the delta
        uplink's (it passes the clients' states) into ``td``, fedcmoo's
        gradient stack (through the EF-stripped codec, no states) into
        ``tg``; with identity codecs both are one codec."""
        fn = codec.roundtrip_stacked

        def wrapped(*a, **kw):
            delta = len(a) > 2
            seen = ((a[0].clone(), [None if s is None else s.clone()
                                    for s in a[2]]) if delta
                    else a[0].clone())
            out = fn(*a, **kw)
            logs["td" if delta else "tg"].append((seen, out))
            return out
        codec.roundtrip_stacked = wrapped
    spy_stacked(ttr.uplink_codec)
    if exchange:
        grad_codec = ttr.algorithm._grad_codec(ttr.uplink_codec)
        if grad_codec is not ttr.uplink_codec:
            spy_stacked(grad_codec)
    server_solve = jfedcmoo.server_solve

    def spy_solve(mats, *a, **kw):
        logs["server"].append(_server_curvature(mats))
        return server_solve(mats, *a, **kw)

    schedule = [jtr._sample_participants(round_idx=r)
                for r in range(n_rounds)]
    cases, carried = [], None
    jfedcmoo.server_solve = spy_solve
    try:
        for r, parts in enumerate(schedule):
            steps = [ttr._client_fcs[c].local_steps for c in parts]
            draws, jd = _round_draws(jtr, jcfg, steps, exchange, parts)
            _, _, jb = jtr.downlink_codec.roundtrip(
                jtr.global_trainable, jtr._downlink_state, key=jd["down"])
            curvature = None
            if one_client is not None:
                curvature = _client_curvature(jtr, one_client, jb, jd, parts,
                                              steps, jfc_res.beta)
            n_solves, n_grads = len(logs["server"]), len(logs["tg"])
            want = jtr.run_round()
            if exchange:
                assert len(logs["server"]) == n_solves + k
                curvature = min(logs["server"][n_solves:])
            got = ttr.run_round(parts, **draws)
            cases.append(RoundCase(
                name, r + 1, got, want,
                1 / min(1.0, curvature if curvature is not None else 1.0),
                weights, up, jtr._delta_spec, jd["up"], jd["grad"],
                _flat(jb), _flat(logs["tb"][-1][1][1]), logs["jd"][-1][0],
                logs["td"][-1],
                logs["tg"][n_grads:], _flat(jtr.global_trainable),
                _flat(ttr.global_trainable), carried))
            carried = [None if s is None else s.clone()
                       for s in ttr._uplink_state]
    finally:
        jfedcmoo.server_solve = server_solve
    return cases


CASES = {
    "loop_firm_wan": ("firm", "wan", 2, dict(vectorized_clients=False)),
    "loop_linear_wan": ("linear", "wan", 1, dict(vectorized_clients=False)),
    "loop_fedcmoo_datacenter": ("fedcmoo", "datacenter", 2,
                                dict(vectorized_clients=False)),
    "loop_fedcmoo_wan": ("fedcmoo", "wan", 1, dict(vectorized_clients=False)),
}


def run_cases(cases):
    """Every round of every case of ``cases`` (name: (algorithm, preset,
    rounds, keywords of ``_run_case``)), keyed by its test id."""
    out = {}
    for name, (algorithm, preset, n_rounds, kw) in cases.items():
        for case in _run_case(name, algorithm, preset, n_rounds, **kw):
            out[f"{name}_round{case.n_round}"
                + ("_carried" if case.n_round > 1 else "")] = case
    return out


@pytest.fixture(scope="module")
def rounds():
    return run_cases(CASES)


@pytest.mark.parametrize("case", [
    "loop_firm_wan_round1", "loop_firm_wan_round2_carried",
    "loop_linear_wan_round1",
    "loop_fedcmoo_datacenter_round1",
    "loop_fedcmoo_datacenter_round2_carried", "loop_fedcmoo_wan_round1"])
def test_round_matches_the_jax_round_of_the_same_executor(rounds, case):
    check_round(rounds[case], case)


def check_round(rc, case):
    """Hold one round of the port to the JAX round of its case."""
    got, want = rc.got, rc.want
    n = len(want["participants"])
    # bytes, participants, dispatches and cohorts exact among the rest
    _summary_close(got, want, rc.slack, rc.weights, n_participants=n)
    if case.startswith("loop"):
        assert got["cohorts"] == 0
    elif len(set(got["local_steps"])) > 1:
        assert got["cohorts"] == 2 and got["dispatches"] == 3 * 2 + 4
    if rc.n_round == 1:
        # an anchored round: the same broadcast, bit for bit
        np.testing.assert_array_equal(rc.tbroadcast, rc.jbroadcast)
    (tflats, tstates), tout = rc.tdelta
    for c in range(n):
        _step_close(_np(tflats[c]), rc.jdelta[c], STEP_TOL * rc.slack,
                    f"client {c} delta")
    _step_close(rc.tglobal - rc.tbroadcast, rc.jglobal - rc.jbroadcast,
                STEP_TOL * rc.slack, "global step")
    if rc.up != "identity":
        # the reference's delta codec on the port's input and residuals:
        # the same wire, decoded deltas and residuals, bit for bit
        if rc.carried_from is None:
            assert all(s is None for s in tstates)
        rpay, rstates, rdec = jmake_codec(rc.up).roundtrip_stacked(
            jnp.asarray(_np(tflats)), rc.jspec,
            [None if s is None else jnp.asarray(_np(s)) for s in tstates],
            keys=rc.up_keys)
        tpay, tres, tdec = tout
        for c in range(n):
            for name in rpay[c].arrays:
                np.testing.assert_array_equal(
                    tpay[c].arrays[name].numpy(),
                    np.asarray(rpay[c].arrays[name]),
                    err_msg=f"client {c} {name}")
            np.testing.assert_array_equal(_np(tres[c]),
                                          np.asarray(rstates[c]))
        np.testing.assert_array_equal(_np(tdec), np.asarray(rdec))
    if not case.startswith("loop_fedcmoo"):
        assert rc.tgrads == []
        return
    # the loop's gradient uplink: one stacked roundtrip of the C x M rows
    # a step, each row held to the reference loop's own call, the gradient
    # codec (EF stripped) on that row alone with the JAX key of its row,
    # bit for bit
    lam = got["per_client_lam"]
    assert (lam == lam[0]).all()
    grad_spec = "int8" if rc.up == "int8+ef" else rc.up
    assert len(rc.tgrads) == len(rc.grad_keys) == 2
    for k, (tin, (tpays, _, tdec)) in enumerate(rc.tgrads):
        assert tin.shape[0] == len(tpays) == len(rc.grad_keys[k]) == n * M
        for i, key in enumerate(rc.grad_keys[k]):
            rpay, _, rdec = jmake_codec(grad_spec).roundtrip_flat(
                jnp.asarray(_np(tin[i])), rc.jspec, key=key)
            assert tpays[i].nbytes == rpay.nbytes
            assert sorted(tpays[i].arrays) == sorted(rpay.arrays)
            for name in rpay.arrays:
                np.testing.assert_array_equal(
                    tpays[i].arrays[name].numpy(),
                    np.asarray(rpay.arrays[name]),
                    err_msg=f"step {k} gradient upload {i} {name}")
            np.testing.assert_array_equal(_np(tdec[i]),
                                          np.asarray(rdec)[:tin.shape[1]])


# ------------------------------------------------------- the port alone
def _trainer(algorithm="firm", vectorized=True, steps=None, n_clients=2):
    _, tcfg = _cfgs()
    fc = dataclasses.replace(FIRMConfig(), n_clients=n_clients,
                             local_steps=2, batch_size=B, n_objectives=M,
                             client_local_steps=steps)
    ec = EngineConfig(algorithm=algorithm, prompt_len=P, max_new=4,
                      uplink_codec="int8+ef", vectorized_clients=vectorized)
    return api.plan(api.RunSpec(tcfg, fc, ec)).build(device="cpu")


def _same_state(a, b):
    """Bit for bit: global adapters, every client state, residuals and
    prompt streams."""
    for x, y in zip(trees.tree_leaves(a.global_trainable),
                    trees.tree_leaves(b.global_trainable), strict=True):
        assert torch.equal(x, y)
    for sa, sb in zip(a.client_states, b.client_states, strict=True):
        for x, y in zip(jax.tree_util.tree_leaves(bridge.to_numpy(sa)),
                        jax.tree_util.tree_leaves(bridge.to_numpy(sb)),
                        strict=True):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(a._uplink_state, b._uplink_state, strict=True):
        assert torch.equal(x, y)
    assert [ds.count for ds in a.datasets] == [ds.count for ds in b.datasets]


@pytest.mark.parametrize("algorithm,steps", [
    ("firm", None), ("linear", None), ("fedcmoo", None),
    ("firm", (1, 2, 1))])
def test_the_loop_executor_is_the_vectorized_round_bit_for_bit(algorithm,
                                                               steps):
    """Three rounds from the same seed through the loop executor and
    through the vectorized executor (one cohort, or cohorts for
    heterogeneous K): the same states bit for bit.  Only the reductions
    of the summary and its ``dispatches`` and ``cohorts`` differ."""
    n = 3 if steps else 2
    vec = _trainer(algorithm, True, steps, n_clients=n)
    loop = _trainer(algorithm, False, steps, n_clients=n)
    assert loop.plan.executor == "loop" and vec.plan.executor == "vectorized"
    hv, hl = vec.run(3), loop.run(3)
    _same_state(vec, loop)
    k_total = sum(steps) if steps else 2 * n
    for sv, sl in zip(hv, hl):
        assert sl["cohorts"] == 0
        assert sl["dispatches"] == \
            k_total * loop.algorithm.loop_dispatches_per_client_step + 4
        assert sv["cohorts"] == (2 if steps else 1)
        assert sv["dispatches"] == (3 * 2 + 4 if steps else
                                    5 + vec.algorithm.vec_phase_dispatches(2))
        for key in ("comm_bytes", "participants", "up_nbytes",
                    "local_steps"):
            assert sv[key] == sl[key], key
        np.testing.assert_array_equal(sv["per_client_lam"],
                                      sl["per_client_lam"])
        np.testing.assert_array_equal(sv["rewards_per_client"],
                                      sl["rewards_per_client"])
        for key in ("rewards", "kl", "param_drift"):
            assert_close(sv[key], sl[key], 1e-6, key)


def test_execute_is_the_trainer_run():
    """``plan(spec).execute()`` (and ``api.execute``) on the CPU give the
    history of ``FederatedTrainer(...).run()`` on the same spec."""
    _, tcfg = _cfgs()
    fc = dataclasses.replace(FIRMConfig(), n_clients=2, local_steps=1,
                             batch_size=B, n_objectives=M, rounds=2)
    ec = EngineConfig(prompt_len=P, max_new=4, uplink_codec="int8+ef")
    p = api.plan(api.RunSpec(tcfg, fc, ec))
    histories = [p.execute(device="cpu"), api.execute(p, device="cpu"),
                 FederatedTrainer(tcfg, fc, ec, device="cpu").run()]
    for h in histories[1:]:
        assert len(h) == len(histories[0]) == 2
        for a, b in zip(histories[0], h):
            assert list(a) == list(b)
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]), key)
    assert histories[0][-1]["comm_bytes"] == \
        2 * (p.up_bytes_per_round + p.down_bytes_per_round)


def test_what_is_not_ported_raises_and_never_falls_back(tmp_path):
    """A fused plan runs through the fused executor, in its chunks, from
    ``build().run()`` and ``execute()`` alike; a plan with a scheduler
    builds a ``ScheduledTrainer`` around the planned trainer and runs its
    policy (never the bare engine in its place), and a metrics sink is
    attached to the trainer and written a round's records."""
    _, tcfg = _cfgs()
    fc = dataclasses.replace(FIRMConfig(), n_clients=2, local_steps=1,
                             batch_size=B, n_objectives=M)
    ec = EngineConfig(prompt_len=P, max_new=4, fused_rounds=2)
    p = api.plan(api.RunSpec(tcfg, fc, ec, rounds=2))
    assert p.executor == "fused" and p.fused_chunks == (2,)
    tr = p.build(device="cpu")
    hist = tr.run(2)
    assert [s["fused"] for s in hist] == [2, 2]
    assert [s["dispatches"] for s in hist] == [p.dispatches_per_round] * 2
    assert tr.ledger.total == 2 * (p.up_bytes_per_round
                                   + p.down_bytes_per_round)
    executed = p.execute(device="cpu")
    assert [s["fused"] for s in executed] == [2, 2]
    for a, b in zip(hist, executed):
        np.testing.assert_array_equal(a["rewards_per_client"],
                                      b["rewards_per_client"])
    # the same spec asked per round runs per round, with no fused key
    per_round = api.plan(api.RunSpec(tcfg, fc, dataclasses.replace(
        ec, fused_rounds=1))).build(device="cpu").run(1)[0]
    assert per_round["cohorts"] == 1 and "fused" not in per_round
    sched = api.plan(api.RunSpec(tcfg, fc, EngineConfig(prompt_len=P,
                                                        max_new=4),
                                 sched=SchedConfig(policy="deadline")))
    assert sched.policy == "deadline" and sched.executor == "vectorized"
    st = sched.build(device="cpu")
    assert isinstance(st, ScheduledTrainer)
    assert st.trainer.plan is sched and st.policy.name == "deadline"
    (s,) = st.run(1)
    assert s["policy"] == "deadline" and s["dropped"] == []
    assert s["sim_time"] == s["round_duration"] > 0
    jpath = tmp_path / "m.jsonl"
    tr = FederatedTrainer(tcfg, fc, EngineConfig(
        prompt_len=P, max_new=4, metrics_sink=f"jsonl:{jpath}"),
        device="cpu")
    assert [sink.kind for sink in tr.obs.sinks] == ["memory", "jsonl"]
    tr.run(1)
    tr.obs.close()
    assert len(jpath.read_text().splitlines()) == len(tr.obs.records) > 0
