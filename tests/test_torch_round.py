"""The port's federated round (``repro_torch.fed.engine.FederatedTrainer``)
and the modules it runs (FedAvg, drift, the comms ledger, the round
summary, the launcher and the checkpoints) against the JAX package, on the
CPU at a tiny size.

The round is held against the reference's vectorized executor, the
default: a JAX ``FederatedTrainer`` (``firm``, C = 2, K = 2, f32 weights)
is snapshot before a round, the snapshot is carried into the port's
trainer by ``bridge.load_trainer_state``, and the port's round is fed that
round's JAX draws: the prompt blocks, the Gumbel noise of every generation
key, the uplink rounding bits and, for a quantized downlink, the
downlink's.  Six cases:

* ``round1``, ``round2``: the ``wan`` preset (int8+ef up, identity down),
  each round anchored on its own snapshot, because the reference's own
  executors drift apart over rounds (its loop and vectorized paths are
  held to 2e-2 after 3 rounds);
* ``round2_carried``: a second port trainer loaded once, before round 1,
  runs both rounds on its own state, so round 2's error-feedback residual
  is the port's own round-1 residual;
* ``mobile_round1``: the ``mobile`` preset (int4+ef up, int8 down), with
  the downlink's bits injected;
* ``extreme_round1``, ``extreme_round2_carried``: the ``extreme`` preset
  (topk:0.05+ef up, int8 down), round 1 anchored, round 2 on the port's
  own state and residuals.  The top-k uplink reads no draw, but the
  trainer still takes one a client from its stream.

Tolerances.  Bytes, participants, dispatches, tokens and rewards are
exact, and so is the broadcast of an anchored round.  Drift agrees within 1e-4 of its own
scale: the two sides sum in other orders.  KL is a mean of differences of
logprobs of size ~log V = 5.5, each known to about an f32 ulp there
(4.8e-7), and is held to 1e-6 absolute (0.5% of its size in round 1).  The adapters move by
actor_lr times an Adam step; the steps (each client's codec input and the
new global against the broadcast, over actor_lr) are held to 1e-2 of
their own scale, as in the local-step test (``test_torch_training.py``):
where |g| is near Adam's eps the step is sensitive to the last bits of g.
lambda and the steps are held to those tolerances over min(1, D), where
D = Q11 + Q22 - 2 Q12 is the curvature of the regularised MGDA problem
(Q = G / (tr G / M) + beta/2 I) at the round's worst-conditioned step,
computed from the reference's own Gram matrices: for M = 2 the solution
lambda* = (Q22 - Q12) / D moves by about 1/D times a perturbation of Q,
so the last bits in which the two sides' rollouts and gradients differ
move lambda, and the steps it weighs, by that much.  In round 2 here D
falls to ~0.08; there the reference's own lambda moves by ~2e-4 between
its vmapped round and the same steps run op by op on the port's rollouts.

The error-feedback residual is the quantization error of the codec's
input, about one step (absmax / 127) in size.  The input differs from
the reference's by up to ~1e-2 of an Adam step, which is as large as
that step, and moves a stochastic code by one in some entries; so the
two rounds' residuals cannot agree entry for entry.  What is held instead
is the uplink on the round's own data: the reference's codec, given the
port's codec input, carried residuals and this round's keys, returns the
port's payloads (codes and scales, or indices and values), decoded deltas
and residuals bit for bit; and the
residual the port hands its codec is the one loaded (anchored rounds) or
its own of the round before (``round2_carried``).  ``test_torch_codec.py``
holds the codec alone to the reference bit for bit on the same inputs.
"""
import dataclasses
import json
from typing import NamedTuple, Optional

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comms import make_codec as jmake_codec  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.core import comms as jcomms  # noqa: E402
from repro.core import drift as jdrift, fedavg as jfedavg  # noqa: E402
from repro.data.partition import sample_prompt_block  # noqa: E402
from repro.fed import engine as jengine  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.obs import records as jrecords  # noqa: E402
from repro.rlhf import local as jlocal  # noqa: E402
from repro.rlhf import ppo as jppo, rewards as jrewards  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
from repro.train import checkpoint as jcheckpoint  # noqa: E402
from repro_torch import bridge, trees  # noqa: E402
from repro_torch.comms import make_codec  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.core import comms, drift, fedavg  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.obs import records  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

C, K, B, P, MAX_NEW, M = 2, 2, 2, 4, 8, 2
TOL = 1e-4          # summary statistics, of their own scale
STEP_TOL = 1e-2     # Adam steps (moves over actor_lr), of their own scale
KL_ATOL = 1e-6      # KL, absolute: see the module docstring


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, tol, what=""):
    """|got - want| <= tol * max|want|, element for element."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    limit = tol * (float(np.abs(w).max()) if w.size else 0.0)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def _cfgs():
    jcfg = dataclasses.replace(
        jax_get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                               vocab=256), n_kv_heads=2)
    tcfg = dataclasses.replace(
        get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                           vocab=256), n_kv_heads=2)
    return jcfg, tcfg


# ------------------------------------------------------- FedAvg and drift
def _stacked_tree(seed, c=3):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((c, 4, 5)).astype(np.float32),
            "b": {"x": rng.standard_normal((c, 7)).astype(np.float32),
                  "n": None}}


def test_fedavg_matches_jax():
    tree = _stacked_tree(0)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = bridge.to_torch(tree, device="cpu")
    # 1e-6 of the scale: the weighted sums run in other orders
    for got, want in zip(trees.tree_leaves(fedavg.fedavg_stacked(tt)),
                         jax.tree_util.tree_leaves(
                             jfedavg.fedavg_stacked(jt))):
        assert_close(got, want, 1e-6, "fedavg_stacked")
    parts = fedavg.unstack_tree(tt, 3)
    assert parts[1]["b"]["n"] is None
    assert torch.equal(parts[2]["w"], tt["w"][2])
    restacked = fedavg.stack_trees(parts)
    assert all(torch.equal(a, b) for a, b in zip(
        trees.tree_leaves(restacked), trees.tree_leaves(tt)))
    for stale in ([0, 0, 0], [0, 2, 5]):
        w = fedavg.staleness_weights(torch.tensor(stale), 0.5)
        assert_close(w, jfedavg.staleness_weights(jnp.asarray(stale), 0.5),
                     1e-6, "staleness weights")
        flats = torch.cat([t.reshape(3, -1)
                           for t in trees.tree_leaves(tt)], 1)
        assert_close(fedavg.fedavg_flat_weighted(flats, w),
                     jfedavg.fedavg_flat_weighted(
                         jnp.asarray(flats.numpy()), jnp.asarray(w.numpy())),
                     1e-6, "fedavg_flat_weighted")
    assert torch.equal(fedavg.staleness_weights(torch.zeros(2)),
                       torch.full((2,), 0.5))


@pytest.mark.parametrize("c", [1, 2, 3])
def test_drift_matches_jax(c):
    tree = _stacked_tree(c, c)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = bridge.to_torch(tree, device="cpu")
    assert_close(drift.param_drift_stacked(tt),
                 jdrift.param_drift_stacked(jt), 1e-6, "param_drift_stacked")
    assert_close(drift.param_drift(fedavg.unstack_tree(tt, c)),
                 jdrift.param_drift(jfedavg.unstack_tree(jt, c)), 1e-6,
                 "param_drift")
    lams = np.random.default_rng(c).dirichlet(np.ones(3), c).astype(
        np.float32)
    got = drift.lambda_disagreement(torch.from_numpy(lams))
    want = jdrift.lambda_disagreement(jnp.asarray(lams))
    assert set(got) == set(want)
    for key in want:
        assert_close(got[key], want[key], 1e-6, key)


def test_ledger_and_round_summary_match_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": np.ones(5, np.float32), "n": None}}
    assert comms.tree_param_bytes(bridge.to_torch(tree, device="cpu")) == \
        jcomms.tree_param_bytes(tree) == 68
    jl, tl = jcomms.CommsLedger(), comms.CommsLedger()
    flat = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    payload, _, _ = make_codec("int4+ef").roundtrip_flat(
        flat, make_codec("identity").encode({"a": flat})[0].meta["spec"])
    for ledger, tr in ((jl, tree), (tl, bridge.to_torch(tree, "cpu"))):
        ledger.send_down(tr)
        ledger.next_round()
    jl.send_up(type("P", (), {"arrays": {}, "nbytes": payload.nbytes})())
    tl.send_up(payload)
    assert (tl.up_bytes, tl.down_bytes, tl.total, tl.rounds) == \
        (jl.up_bytes, jl.down_bytes, jl.total, jl.rounds) == (1548, 68,
                                                               1616, 1)
    stats = {"rewards": np.ones(2), "lam_mean": np.ones(2) / 2,
             "lam_disagreement": np.float32(0.1), "param_drift": 2.0,
             "kl": np.float32(-0.5), "per_client_lam": np.ones((2, 2)) / 2,
             "rewards_per_client": np.ones((2, 2))}
    kw = dict(comm_bytes=10, up_bytes=4, down_bytes=6, participants=(0, 1),
              dispatches=6, up_nbytes=(2, 2), down_nbytes=3,
              local_steps=(1, 1), cohorts=1)
    got = records.round_summary(stats=stats, **kw)
    want = jrecords.round_summary(stats=stats, **kw)
    assert list(got) == list(want)
    for key, val in want.items():
        assert type(got[key]) is type(val), key
        np.testing.assert_array_equal(got[key], val)


# ------------------------------------------------------------- the round
def _snapshot(jtr) -> dict:
    """numpy copies of a JAX trainer's state, as ``load_trainer_state``
    takes them."""
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"global_trainable": host(jtr.global_trainable),
            "client_states": [host(s) for s in jtr.client_states],
            "uplink_state": [None if r is None else np.asarray(r)
                             for r in jtr._uplink_state],
            "prompt_counts": [ds._count for ds in jtr.datasets]}


def _round_draws(jtr, jcfg, parts=None):
    """What the next JAX round will draw, replayed from its key: the
    downlink key, K x P generation keys step-major, P uplink keys (the
    order of ``run_round`` on the vectorized path), for the participants
    ``parts`` (default: every client).  Returns the port's injected draws
    and the JAX keys and prompts."""
    parts = list(range(len(jtr.datasets))) if parts is None else parts
    n = len(parts)
    rng = jtr._rng

    def split(r):
        out = jax.random.split(r)
        return out[0], out[1]

    rng, down = split(rng)
    gen = [[None] * n for _ in range(K)]
    for k in range(K):
        for c in range(n):
            rng, gen[k][c] = split(rng)
    up = []
    for _ in range(n):
        rng, kk = split(rng)
        up.append(kk)
    idx = jnp.asarray(parts, jnp.int32)
    counts0 = jnp.asarray([jtr.datasets[c]._count for c in parts],
                          jnp.int32)
    prompts = np.stack([np.asarray(sample_prompt_block(
        jtr._seeds_all[idx], counts0 + k, jtr._probs_all[idx], B, P,
        jcfg.vocab)) for k in range(K)])                  # (K, P, B, P)
    gumbel = np.stack([np.stack([np.stack([
        np.asarray(jax.random.gumbel(s, (B, jcfg.vocab)))
        for s in jax.random.split(gen[k][c], MAX_NEW)])
        for c in range(n)]) for k in range(K)])           # (K, P, T, B, V)
    rows = -(-jtr.d_trainable // 1024)

    def bits(kk):
        return np.asarray(jax.random.bits(kk, (rows, 1024), jnp.uint32)
                          ).view(np.int32)
    draws = {"prompts": torch.from_numpy(prompts).long(),
             "gumbel": torch.from_numpy(gumbel),
             "up_bits": torch.from_numpy(np.stack([bits(kk) for kk in up])),
             "down_bits": torch.from_numpy(bits(down).copy())}
    return draws, {"prompts": prompts, "gen": gen, "up": up, "down": down}


def _qp_curvature(jtr, one_client, start, prompts, gen_keys,
                  parts=None) -> float:
    """The smallest MGDA curvature D (see the module docstring) over the
    round's client-steps, from the reference's own steps: ``one_client``
    of its ``_make_round_fn`` run one participant at a time (``parts``,
    default every client) from the same start, prompts and keys."""
    parts = list(range(len(jtr.datasets))) if parts is None else parts
    curv = []
    for ci, c in enumerate(parts):
        st = jtr.client_states[c]._replace(trainable=start)
        for k in range(K):
            st, met = one_client(st, jnp.asarray(prompts[k, ci]),
                                 gen_keys[k][ci], jtr._bands_h[c],
                                 jtr._bands_x[c], jtr.frozen,
                                 jtr.ref_params)
            g = np.asarray(met["gram"], np.float64)
            q = g / (np.trace(g) / M) + 0.5 * jtr.fc.beta * np.eye(M)
            curv.append(q[0, 0] + q[1, 1] - 2 * q[0, 1])
    return float(min(curv))


def _jit_one_client(jcfg, jfc):
    """``one_client`` of the reference's ``_make_round_fn``, jitted alone."""
    length_tol = max(4, MAX_NEW // 2)

    def one_client(st, prompts, key, bh, bx, frozen, ref_params):
        params = jcommon.merge_trainable(st.trainable, frozen)
        tokens, old_lp, mask = jgenerate(jcfg, params, prompts, key,
                                         max_new=MAX_NEW)
        r = jrewards.score_batch_banded(bh, bx, tokens, mask, M, length_tol)
        ref_lp = jppo.token_logprobs(
            jT.forward_seq(jcfg, ref_params, tokens)["logits"], tokens)
        return jlocal.firm_local_step(
            jcfg, jfc, st, frozen, jppo.PPOBatch(tokens, mask, old_lp, ref_lp,
                                                 r))
    return jax.jit(one_client)


def _f32_model(jtr):
    """Put f32 weights into a fresh JAX trainer (its init draws bf16), so
    both sides can be held to the f32 tolerance."""
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                    jtr.params)
    trainable, frozen = jcommon.split_trainable(params)
    jtr.params, jtr.ref_params, jtr.frozen = params, params, frozen
    jtr.global_trainable = trainable
    jtr.client_states = [
        jlocal.init_client_state(trainable, M, jtr.cfg.d_model,
                                 jtr.fc.kl_coef_init)
        for _ in jtr.client_states]
    return params


def _tflat(tree) -> np.ndarray:
    return np.concatenate([_np(t).reshape(-1)
                           for t in trees.tree_leaves(tree)])


def _jflat(tree) -> np.ndarray:
    return np.concatenate([_np(t).reshape(-1)
                           for t in jax.tree_util.tree_leaves(tree)])


def _spy(obj, name, log, copy):
    """Record every call of ``obj.name`` as (inputs, outputs), copied by
    ``copy`` before the call runs, into ``log``."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        seen = copy(a)
        out = fn(*a, **kw)
        log.append((seen, out))
        return out
    setattr(obj, name, wrapped)


def _port_uplink_in(a):
    flats, _, states = a[:3]
    return (flats.clone(), [None if s is None else s.clone()
                            for s in states])


def _jax_uplink_in(a):
    flats, _, states = a[:3]
    return (np.asarray(flats), [None if s is None else np.asarray(s)
                                for s in states])


class RoundCase(NamedTuple):
    got: dict                    # the port's summary
    want: dict                   # the JAX summary
    curvature: float             # D of the module docstring
    codec: str                   # the uplink spec
    downlink: str                # the downlink spec
    up_keys: list                # the round's JAX uplink keys
    n_round: int                 # rounds run (the ledger's count)
    jspec: object                # the JAX flat TreeSpec of a delta
    jbroadcast: np.ndarray       # what the JAX clients started from (flat)
    tbroadcast: np.ndarray
    juplink: tuple               # (codec inputs, outputs) of the round
    tuplink: tuple
    jglobal: np.ndarray          # the new global adapters (flat)
    tglobal: np.ndarray
    carried_from: Optional[list]  # the port's round-1 residuals, if carried


@pytest.fixture(scope="module")
def rounds():
    """Every case of the module docstring, on one JAX config, so the JAX
    round's compile is paid once."""
    jcfg, tcfg = _cfgs()
    jfc = dataclasses.replace(JFIRMConfig(), n_clients=C, local_steps=K,
                              batch_size=B, n_objectives=M)
    tfc = dataclasses.replace(FIRMConfig(), n_clients=C, local_steps=K,
                              batch_size=B, n_objectives=M)
    one_client = _jit_one_client(jcfg, jfc)
    cases = {}
    # preset, uplink, downlink, rounds, the rounds also run anchored
    for preset, up, down, n_rounds, anchored in (
            ("wan", "int8+ef", "identity", 2, (0, 1)),
            ("mobile", "int4+ef", "int8", 1, (0,)),
            ("extreme", "topk:0.05+ef", "int8", 2, (0,))):
        jtr = jengine.FederatedTrainer(jcfg, jfc, jengine.EngineConfig(
            prompt_len=P, max_new=MAX_NEW, uplink_codec=up,
            downlink_codec=down))
        params = bridge.to_torch(jax.tree_util.tree_map(
            np.asarray, _f32_model(jtr)), device="cpu")
        tec = EngineConfig(prompt_len=P, max_new=MAX_NEW, uplink_codec=up,
                           downlink_codec=down)
        ttr = FederatedTrainer(tcfg, tfc, tec, device="cpu", params=params)
        carried = FederatedTrainer(tcfg, tfc, tec, device="cpu",
                                   params=params)
        logs = {"j": [], "t": [], "c": [], "tb": [], "cb": []}
        _spy(jtr.uplink_codec, "roundtrip_stacked", logs["j"],
             _jax_uplink_in)
        for tr, log, blog in ((ttr, logs["t"], logs["tb"]),
                              (carried, logs["c"], logs["cb"])):
            _spy(tr.uplink_codec, "roundtrip_stacked", log, _port_uplink_in)
            _spy(tr, "_local_phase", blog, lambda a: _tflat(a[1]))
        for r in range(n_rounds):
            snap = _snapshot(jtr)
            draws, jd = _round_draws(jtr, jcfg)
            _, _, jb = jtr.downlink_codec.roundtrip(
                jtr.global_trainable, jtr._downlink_state, key=jd["down"])
            curvature = _qp_curvature(jtr, one_client, jb, jd["prompts"],
                                      jd["gen"])
            want = jtr.run_round()
            ports = []
            if r in anchored:
                bridge.load_trainer_state(ttr, snap)
                ports.append(("", ttr, logs["t"], logs["tb"]))
            if r == 0:
                bridge.load_trainer_state(carried, snap)
            else:
                ports.append(("_carried", carried, logs["c"], logs["cb"]))
            for suffix, tr, log, blog in ports:
                got = tr.run_round(**draws)
                cases[("round" if preset == "wan" else f"{preset}_round")
                      + f"{r + 1}{suffix}"] = RoundCase(
                    got, want, curvature, up, down, jd["up"], r + 1,
                    jtr._delta_spec,
                    _jflat(jb),
                    blog[-1][0], logs["j"][-1], log[-1],
                    _jflat(jtr.global_trainable),
                    _tflat(tr.global_trainable),
                    logs["c"][0][1][1] if suffix else None)
            if r == 0 and n_rounds > 1:
                carried.run_round(**draws)
    return cases


def _step_close(got, want, tol, what):
    """Adapter moves over actor_lr, within ``tol`` of their own scale."""
    lr = FIRMConfig().actor_lr
    assert_close(got / lr, want / lr, tol, what)


@pytest.mark.parametrize("case", ["round1", "round2", "round2_carried",
                                  "mobile_round1", "extreme_round1",
                                  "extreme_round2_carried"])
def test_round_matches_jax_vectorized_round(rounds, case):
    got, want, curvature, spec, down, up_keys, n_round, jspec, jb, tb, \
        (jin, _), (tin, tout), jglobal, tglobal, carried_from = rounds[case]
    assert list(got) == list(want)
    for key in ("comm_bytes", "up_bytes", "down_bytes", "participants",
                "dispatches", "up_nbytes", "down_nbytes", "local_steps",
                "cohorts"):
        assert got[key] == want[key], key
    assert got["dispatches"] == 6 and got["cohorts"] == 1
    d = 14336
    assert got["comm_bytes"] == n_round * C * (
        make_codec(spec).nbytes_static(d) + make_codec(down).nbytes_static(d))
    if carried_from is None:
        # the same broadcast, bit for bit (int8 down: the injected bits)
        np.testing.assert_array_equal(tb, jb)
    # the same tokens: the same rewards, bit for bit
    np.testing.assert_array_equal(got["rewards_per_client"],
                                  want["rewards_per_client"])
    np.testing.assert_array_equal(got["rewards"], want["rewards"])
    assert_close(got["param_drift"], want["param_drift"], TOL, "drift")
    assert abs(got["kl"] - want["kl"]) <= KL_ATOL, (got["kl"], want["kl"])
    assert got["param_drift"] > 0
    slack = 1 / min(1.0, curvature)
    for key in ("lam_mean", "per_client_lam", "lam_disagreement"):
        assert_close(got[key], want[key], TOL * slack, key)
    # each client's codec input (its K-step delta plus nothing: the
    # residual is added inside the codec) and the new global's move
    tflats, tstates = tin
    jflats, jstates = jin
    for c in range(C):
        _step_close(_np(tflats[c]), jflats[c], STEP_TOL * slack,
                    f"client {c} delta")
    _step_close(tglobal - tb, jglobal - jb, STEP_TOL * slack, "global step")
    # FedAvg of both clients' decoded deltas
    tdecoded = _np(tout[2])
    assert_close(tglobal - tb, tdecoded.mean(0), 1e-3, "FedAvg of decoded")
    # the residual the codec was handed: none in round 1, else the one
    # loaded from the reference or the port's own of round 1
    for c in range(C):
        if n_round == 1:
            assert tstates[c] is None and jstates[c] is None
        elif carried_from is not None:
            assert torch.equal(tstates[c], carried_from[c])
        else:
            np.testing.assert_array_equal(_np(tstates[c]), jstates[c])
    # the reference's codec on the port's input: the same wire, decoded
    # deltas and residuals, bit for bit
    rpay, rstates, rdec = jmake_codec(spec).roundtrip_stacked(
        jnp.asarray(_np(tflats)), jspec,
        [None if s is None else jnp.asarray(_np(s)) for s in tstates],
        keys=up_keys)
    tpay, tres, _ = tout
    for c in range(C):
        assert sorted(tpay[c].arrays) == sorted(rpay[c].arrays)
        for name in rpay[c].arrays:
            np.testing.assert_array_equal(
                tpay[c].arrays[name].numpy(), np.asarray(
                    rpay[c].arrays[name]), err_msg=f"client {c} {name}")
        np.testing.assert_array_equal(_np(tres[c]), np.asarray(rstates[c]),
                                      err_msg=f"client {c} residual")
    np.testing.assert_array_equal(tdecoded, np.asarray(rdec))


def test_partial_participation_rounds_match_jax_with_its_participants():
    """C = 4 clients at participation 0.5, R = 2 rounds of the ``wan``
    preset.  The port's own participant draw is not the reference's, so
    the reference's (``_sample_participants(round_idx=r)``) is handed to
    the port as ``run(R, participants=schedule)``, with each round's JAX
    draws; the port runs both rounds on its own state (loaded once, before
    round 1).  Each round's summary is held to the reference vectorized
    round's with the tolerances of ``test_round_matches_jax_vectorized_round``.
    """
    n_clients, n_rounds = 4, 2
    jcfg, tcfg = _cfgs()
    fields = dict(n_clients=n_clients, local_steps=K, batch_size=B,
                  n_objectives=M, participation=0.5)
    jfc = dataclasses.replace(JFIRMConfig(), **fields)
    tfc = dataclasses.replace(FIRMConfig(), **fields)
    codecs = dict(prompt_len=P, max_new=MAX_NEW, uplink_codec="int8+ef",
                  downlink_codec="identity")
    jtr = jengine.FederatedTrainer(jcfg, jfc, jengine.EngineConfig(**codecs))
    params = bridge.to_torch(jax.tree_util.tree_map(
        np.asarray, _f32_model(jtr)), device="cpu")
    ttr = FederatedTrainer(tcfg, tfc, EngineConfig(**codecs), device="cpu",
                           params=params)
    bridge.load_trainer_state(ttr, _snapshot(jtr))
    one_client = _jit_one_client(jcfg, jfc)
    schedule = [jtr._sample_participants(round_idx=r)
                for r in range(n_rounds)]
    assert all(len(p) == 2 and p == sorted(set(p)) for p in schedule)
    wants, draws, curvature = [], [], []
    for parts in schedule:
        d, jd = _round_draws(jtr, jcfg, parts)
        _, _, jb = jtr.downlink_codec.roundtrip(
            jtr.global_trainable, jtr._downlink_state, key=jd["down"])
        curvature.append(_qp_curvature(jtr, one_client, jb, jd["prompts"],
                                       jd["gen"], parts))
        draws.append(d)
        wants.append(jtr.run_round())
    assert [w["participants"] for w in wants] == schedule
    # run() hands each round its entry of the schedule; the spy adds that
    # round's JAX draws
    run_round, seen = ttr.run_round, []

    def with_draws(participants=None, **kw):
        seen.append(participants)
        return run_round(participants, **draws[len(seen) - 1])
    ttr.run_round = with_draws
    gots = ttr.run(n_rounds, participants=schedule)
    assert seen == schedule and len(gots) == n_rounds
    for got, want, curv in zip(gots, wants, curvature):
        assert list(got) == list(want)
        for key in ("comm_bytes", "up_bytes", "down_bytes", "participants",
                    "dispatches", "up_nbytes", "down_nbytes", "local_steps",
                    "cohorts"):
            assert got[key] == want[key], key
        np.testing.assert_array_equal(got["rewards_per_client"],
                                      want["rewards_per_client"])
        np.testing.assert_array_equal(got["rewards"], want["rewards"])
        assert_close(got["param_drift"], want["param_drift"], TOL, "drift")
        assert abs(got["kl"] - want["kl"]) <= KL_ATOL, (got["kl"],
                                                       want["kl"])
        slack = 1 / min(1.0, curv)
        for key in ("lam_mean", "per_client_lam", "lam_disagreement"):
            assert_close(got[key], want[key], TOL * slack, key)
    assert [ds.count for ds in ttr.datasets] == \
        [ds._count for ds in jtr.datasets]
    with pytest.raises(ValueError, match="one entry a round"):
        ttr.run(n_rounds, participants=schedule[:1])


def test_round_bookkeeping_on_the_port_alone():
    """A port-only run: draws from the trainer's own streams, partial
    participation, per-client preferences and reward bands."""
    _, tcfg = _cfgs()
    fc = dataclasses.replace(
        FIRMConfig(), n_clients=3, local_steps=1, batch_size=B,
        n_objectives=M, participation=0.67,
        client_preferences=((0.8, 0.2), (0.5, 0.5), (0.2, 0.8)))
    ec = EngineConfig(prompt_len=P, max_new=4, uplink_codec="int4+ef",
                      downlink_codec="int8", heterogeneous_rms=True, seed=3)
    tr = FederatedTrainer(tcfg, fc, ec, device="cpu")
    parts = [tr._sample_participants(round_idx=r) for r in range(4)]
    assert all(len(p) == 2 and p == sorted(set(p)) for p in parts)
    # keyed on (seed, round) alone: drawing from the main stream in
    # between leaves the draw as it was
    tr._next_key()
    assert tr._sample_participants(round_idx=2) == parts[2]
    hist = tr.run(2)
    d = tr.d_trainable
    up, down = make_codec("int4+ef").nbytes_static(d), \
        make_codec("int8").nbytes_static(d)
    assert [s["participants"] for s in hist] == parts[:2]
    assert hist[-1]["comm_bytes"] == 2 * 2 * (up + down)
    assert all(s["up_nbytes"] == [up, up] and s["down_nbytes"] == down
               for s in hist)
    lam = hist[-1]["per_client_lam"]
    assert lam.shape == (2, M) and np.allclose(lam.sum(-1), 1, atol=1e-5)
    assert np.isfinite(hist[-1]["lam_disagreement"])
    assert [ds.count for ds in tr.datasets] == [
        sum(c in p for p in parts[:2]) for c in range(3)]
    with pytest.raises(ValueError, match="unknown algorithm 'fedavg'"):
        FederatedTrainer(tcfg, fc, EngineConfig(algorithm="fedavg"),
                         device="cpu")
    # heterogeneous client_local_steps run as cohorts, one a distinct K
    het = FederatedTrainer(tcfg, dataclasses.replace(
        fc, participation=1.0, client_local_steps=(1, 2, 1)), ec,
        device="cpu")
    s = het.run_round()
    assert s["local_steps"] == [1, 2, 1] and s["cohorts"] == 2
    assert [ds.count for ds in het.datasets] == [1, 2, 1]


def test_topk_uplink_reads_the_stream_as_a_quantized_uplink_does():
    """The top-k uplink reads no draw, but the trainer takes one a
    participant from its main stream all the same, as the reference splits
    one key a participant whatever the codec: later rounds' draws stay
    where the reference's are."""
    _, tcfg = _cfgs()
    fc = dataclasses.replace(FIRMConfig(), n_clients=C, local_steps=1,
                             batch_size=B, n_objectives=M)
    streams = []
    for spec in ("int8+ef", "topk:0.05+ef", "lowrank:4+ef"):
        tr = FederatedTrainer(tcfg, fc, EngineConfig(
            prompt_len=P, max_new=4, uplink_codec=spec), device="cpu")
        before = tr._rng.get_state()
        flats = torch.randn((C, tr.d_trainable),
                            generator=torch.Generator().manual_seed(0))
        _, decoded = tr._uplink([0, 1], flats)
        assert decoded.shape == flats.shape
        assert tr.ledger.up_bytes == C * tr.uplink_codec.nbytes_static(
            tr.d_trainable)
        assert all(r is not None for r in tr._uplink_state)
        streams.append(tr._rng.get_state())
        assert not torch.equal(streams[-1], before)
    assert all(torch.equal(st, streams[0]) for st in streams)


# ------------------------------------------------ checkpoints and launcher
def test_checkpoint_matches_jax_layout(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"slots": {"0": {"attn": {"wq": {
        "lora_A": rng.standard_normal((2, 4, 3)).astype(np.float32),
        "w": None}}}},
        "embed": np.asarray(jnp.asarray(rng.standard_normal((3, 2)),
                                        jnp.bfloat16))}
    ttree = bridge.to_torch(tree, device="cpu")
    checkpoint.save(str(tmp_path / "t.npz"), ttree, step=3)
    jcheckpoint.save(str(tmp_path / "j.npz"), tree, step=3)
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    back, step = checkpoint.restore(str(tmp_path / "j.npz"), ttree)
    assert step == 3 and back["slots"]["0"]["attn"]["wq"]["w"] is None
    assert back["embed"].dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(trees.tree_leaves(back),
                                                 trees.tree_leaves(ttree)))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path / "t.npz"),
                           {"embed": torch.zeros(2, 2)})


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = tmp_path / "run"
    trainer = train.main(["--rounds", "2", "--clients", "2",
                          "--local-steps", "1", "--batch-size", "2",
                          "--max-new", "4", "--layers", "2", "--d-model",
                          "64", "--vocab", "256", "--device", "cpu",
                          "--out", str(out)])
    assert "round 2/2" in capsys.readouterr().out
    hist = json.loads((out / "history.json").read_text())["history"]
    assert len(hist) == 2 and hist[-1]["comm_bytes"] == \
        trainer.ledger.total
    restored, step = checkpoint.restore(str(out / "adapters.npz"),
                                        trainer.global_trainable)
    assert step == 2
    assert all(torch.equal(a, b) for a, b in zip(
        trees.tree_leaves(restored),
        trees.tree_leaves(trainer.global_trainable)))
