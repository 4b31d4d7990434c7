"""Rounds of the port's ``firm_unreg``, ``linear`` and ``fedcmoo`` against
the JAX package's vectorized executor, on the CPU at a tiny size (the f32
llama of ``test_torch_round.py``: 2 layers, d_model 64, vocab 256; C = 2,
K = 2, B = 2).

Each JAX trainer's state is carried into the port's trainer by
``bridge.load_trainer_state`` before round 1 (anchored), and round 2 runs
on the port's own state (carried).  Every JAX draw is replayed from the
JAX trainer's key in the order its vectorized round reads it and handed
to the port: the downlink key; for ``firm_unreg`` and ``linear`` K x P
generation keys step-major; for ``fedcmoo``, per step, for each
participant one generation key then M gradient-codec keys, then one
lambda key; then P uplink keys.  The port takes the prompt blocks, the
Gumbel noise of each generation key, the uplink's rounding bits, the
gradient uplink's rounding bits (``grad_bits``) and the sketch's normal
draw (``sketch_noise``).  Cases:

* ``firm_unreg`` ``wan``: round 1 anchored, round 2 carried;
* ``linear`` ``wan`` with the default weights and with (0.7, 0.3): round
  1 anchored, round 2 carried;
* ``fedcmoo`` ``datacenter`` (identity both ways): round 1 anchored,
  round 2 carried;
* ``fedcmoo`` ``wan`` round 1: the int8 gradient uplink held bit for bit
  on the port's own (C * M, d) input with JAX's keys;
* ``fedcmoo`` with ``fedcmoo_compress_rank=8``, JAX's sketch draw
  injected;
* ``fedcmoo`` at participation 0.5 of C = 4, two rounds, given the
  reference's participants.

Tolerances, as ``test_torch_round.py``'s docstring sets them out: bytes,
participants, dispatches (6, or 5 + 4K for ``fedcmoo``), tokens and
rewards exact; drift within 1e-4 of its scale; KL within 1e-6 absolute;
the steps (each client's delta and the new global's move, over
actor_lr) within 1e-2 of their scale; lambda within 1e-4; lambda and the
steps over min(1, D), D the curvature of the MGDA problem that was
solved: for ``firm_unreg`` the clients' at beta = 0 (from the
reference's own steps), for ``fedcmoo`` the server's trace-normalised
average Gram at beta = 0, taken by spying on the reference's
``fedcmoo.server_solve``.  ``linear`` solves nothing: its lambda is its
weights, exactly.  The loop executor is not an anchor: the reference's
own loop and vectorized rounds drift apart
(``test_loop_vs_vectorized_multi_round[firm]`` fails in the reference).
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
from repro.core import fedcmoo as jfedcmoo  # noqa: E402
from repro.data.partition import sample_prompt_block  # noqa: E402
from repro.fed import algorithms as jalg  # noqa: E402
from repro.fed import engine as jengine  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.rlhf import local as jlocal  # noqa: E402
from repro.rlhf import ppo as jppo, rewards as jrewards  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.comms import make_codec  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.configs.base import CODEC_PRESETS  # noqa: E402
from repro_torch.fed.algorithms import get_algorithm  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa

C, K, B, P, MAX_NEW, M = 2, 2, 2, 4, 8, 2
RANK = 8
TOL = 1e-4          # summary statistics, of their own scale
STEP_TOL = 1e-2     # steps (moves over actor_lr), of their own scale
KL_ATOL = 1e-6      # KL, absolute
OUTLIERS = 2e-3     # share of a step's entries past STEP_TOL: _step_close
# lambda_disagreement of identical rows: sqrt(0 + 1e-30) in f32, the floor
# the reference's formula keeps under its square root
SAME_ROWS = float(np.sqrt(np.float32(1e-30)))
EXACT_KEYS = ("comm_bytes", "up_bytes", "down_bytes", "participants",
              "dispatches", "up_nbytes", "down_nbytes", "local_steps",
              "cohorts")


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


def _f32_model(jtr):
    """f32 weights in a fresh JAX trainer (its init draws bf16)."""
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


def _snapshot(jtr) -> dict:
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"global_trainable": host(jtr.global_trainable),
            "client_states": [host(s) for s in jtr.client_states],
            "uplink_state": [None if r is None else np.asarray(r)
                             for r in jtr._uplink_state],
            "prompt_counts": [ds._count for ds in jtr.datasets]}


def _round_draws(jtr, jcfg, exchange: bool, parts=None,
                 rank: Optional[int] = None):
    """What the next JAX vectorized round will draw, replayed from its
    key in its order (``exchange``: fedcmoo's, else firm's; see the module
    docstring), for the participants ``parts`` (default: every client).
    Returns the port's injected draws and the JAX keys and prompts."""
    parts = list(range(len(jtr.datasets))) if parts is None else parts
    n = len(parts)
    rng = jtr._rng

    def split(r):
        out = jax.random.split(r)
        return out[0], out[1]

    rng, down = split(rng)
    gen = [[None] * n for _ in range(K)]
    grad = [[] for _ in range(K)]
    lam = []
    if exchange:
        for k in range(K):
            for c in range(n):
                rng, gen[k][c] = split(rng)
                for _ in range(M):
                    rng, kk = split(rng)
                    grad[k].append(kk)
            rng, kk = split(rng)
            lam.append(kk)
    else:
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
    d = jtr.d_trainable
    rows = -(-d // 1024)

    def bits(kk):
        return np.asarray(jax.random.bits(kk, (rows, 1024), jnp.uint32)
                          ).view(np.int32)
    draws = {"prompts": torch.from_numpy(prompts).long(),
             "gumbel": torch.from_numpy(gumbel),
             "up_bits": torch.from_numpy(np.stack([bits(kk) for kk in up]))}
    if exchange:
        draws["grad_bits"] = torch.from_numpy(np.stack(
            [np.stack([bits(kk) for kk in grad[k]]) for k in range(K)]))
        if rank:
            # every client is sketched with the first client's draw
            draws["sketch_noise"] = torch.from_numpy(np.stack([np.asarray(
                jax.random.normal(jax.random.split(lam[k], n)[0], (d, rank),
                                  jnp.float32)) for k in range(K)]))
    return draws, {"prompts": prompts, "gen": gen, "up": up, "grad": grad,
                   "down": down}


def _jit_one_client(jcfg, jfc, weights=None):
    """``one_client`` of the reference's ``_make_round_fn`` under ``jfc``,
    jitted alone: FIRM's step, or the linear step with ``weights``."""
    length_tol = max(4, MAX_NEW // 2)

    def one_client(st, prompts, key, bh, bx, frozen, ref_params):
        params = jcommon.merge_trainable(st.trainable, frozen)
        tokens, old_lp, mask = jgenerate(jcfg, params, prompts, key,
                                         max_new=MAX_NEW)
        r = jrewards.score_batch_banded(bh, bx, tokens, mask, M, length_tol)
        ref_lp = jppo.token_logprobs(
            jT.forward_seq(jcfg, ref_params, tokens)["logits"], tokens)
        batch = jppo.PPOBatch(tokens, mask, old_lp, ref_lp, r)
        if weights is None:
            return jlocal.firm_local_step(jcfg, jfc, st, frozen, batch)
        return jlocal.linear_local_step(jcfg, jfc, st, frozen, batch,
                                        jnp.asarray(weights, jnp.float32))
    return jax.jit(one_client)


def _client_curvature(jtr, one_client, start, jd, beta):
    """The smallest MGDA curvature over the round's client-steps, from the
    reference's own steps run one participant at a time from the round's
    start, prompts and keys; None for the linear step, which solves
    nothing."""
    curv = []
    for c in range(len(jtr.datasets)):
        st = jtr.client_states[c]._replace(trainable=start)
        for k in range(K):
            st, met = one_client(st, jnp.asarray(jd["prompts"][k, c]),
                                 jd["gen"][k][c], jtr._bands_h[c],
                                 jtr._bands_x[c], jtr.frozen, jtr.ref_params)
            if "gram" in met:
                g = np.asarray(met["gram"], np.float64)
                q = g / (np.trace(g) / M) + 0.5 * beta * np.eye(M)
                curv.append(q[0, 0] + q[1, 1] - 2 * q[0, 1])
    return float(min(curv)) if curv else None


def _server_curvature(mats) -> float:
    """D of the server's problem: the trace-normalised Gram of the
    clients' average matrix at beta = 0."""
    avg = sum(np.asarray(a, np.float64) for a in mats) / len(mats)
    g = avg @ avg.T
    q = g / (np.trace(g) / M)
    return q[0, 0] + q[1, 1] - 2 * q[0, 1]


def _flat(tree) -> np.ndarray:
    """A port or JAX tree's leaves in sorted-key order, flat, as numpy."""
    return np.concatenate([_np(t).reshape(-1)
                           for t in jax.tree_util.tree_leaves(tree)])


def _spy(obj, name, log, copy):
    """Record every call of ``obj.name`` as (copied inputs, outputs)."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        seen = copy(a)
        out = fn(*a, **kw)
        log.append((seen, out))
        return out
    setattr(obj, name, wrapped)


class RoundCase(NamedTuple):
    algorithm: str
    preset: str
    n_round: int
    got: dict
    want: dict
    slack: float                 # 1 / min(1, D)
    weights: Optional[tuple]     # linear's lambda
    jspec: object                # the JAX flat TreeSpec of a delta
    up_keys: list
    grad_keys: list              # per step, the JAX gradient-codec keys
    jbroadcast: np.ndarray
    tbroadcast: np.ndarray
    jdelta: np.ndarray           # (P, d) codec input of the delta uplink
    tdelta: tuple                # (inputs, residuals in), outputs
    tgrads: list                 # per step (input, outputs) of grad codec
    jglobal: np.ndarray
    tglobal: np.ndarray
    carried_from: Optional[list]  # the port's round-1 residuals


def _run_case(algorithm, preset, n_rounds, **ec_kw):
    """n_rounds rounds of one JAX trainer and one port trainer loaded from
    its snapshot before round 1; returns one RoundCase a round."""
    jcfg, tcfg = _cfgs()
    fields = dict(n_clients=C, local_steps=K, batch_size=B, n_objectives=M)
    jfc = dataclasses.replace(JFIRMConfig(), **fields)
    tfc = dataclasses.replace(FIRMConfig(), **fields)
    up, down = CODEC_PRESETS[preset]
    common_kw = dict(algorithm=algorithm, prompt_len=P, max_new=MAX_NEW,
                     uplink_codec=up, downlink_codec=down, **ec_kw)
    jtr = jengine.FederatedTrainer(jcfg, jfc,
                                   jengine.EngineConfig(**common_kw))
    params = bridge.to_torch(jax.tree_util.tree_map(
        np.asarray, _f32_model(jtr)), device="cpu")
    ttr = FederatedTrainer(tcfg, tfc, EngineConfig(**common_kw),
                           device="cpu", params=params)
    bridge.load_trainer_state(ttr, _snapshot(jtr))
    exchange = not ttr.algorithm.caps.traced_server_exchange
    rank = ec_kw.get("fedcmoo_compress_rank")
    jfc_res = jalg.get_algorithm(algorithm).resolve_config(jfc)
    weights = (tuple(ec_kw.get("linear_weights") or (0.5, 0.5))
               if algorithm == "linear" else None)
    one_client = (None if exchange else
                  _jit_one_client(jcfg, jfc_res, weights))
    logs = {"jd": [], "td": [], "tg": [], "tb": [], "server": []}
    # the delta uplink's input on both sides: the last uplink call of a
    # round (an identity uplink also carries fedcmoo's gradients)
    _spy(jtr.uplink_codec, "roundtrip_stacked", logs["jd"],
         lambda a: np.asarray(a[0]))
    _spy(ttr.uplink_codec, "roundtrip_stacked", logs["td"],
         lambda a: (a[0].clone(), [None if s is None else s.clone()
                                   for s in (a[2] if len(a) > 2 and a[2]
                                             is not None else [])]))
    grad_codec = get_algorithm("fedcmoo")._grad_codec(ttr.uplink_codec)
    if grad_codec is not ttr.uplink_codec:
        _spy(grad_codec, "roundtrip_stacked", logs["tg"],
             lambda a: a[0].clone())
    _spy(ttr, "_local_phase", logs["tb"], lambda a: _flat(a[1]))
    server_solve = jfedcmoo.server_solve

    def spy_solve(mats, *a, **kw):
        logs["server"].append(_server_curvature(mats))
        return server_solve(mats, *a, **kw)

    cases, first_residuals = [], None
    jfedcmoo.server_solve = spy_solve
    try:
        for r in range(n_rounds):
            draws, jd = _round_draws(jtr, jcfg, exchange, rank=rank)
            _, _, jb = jtr.downlink_codec.roundtrip(
                jtr.global_trainable, jtr._downlink_state, key=jd["down"])
            if one_client is not None:
                curvature = _client_curvature(jtr, one_client, jb, jd,
                                              jfc_res.beta)
            n_solves = len(logs["server"])
            want = jtr.run_round()
            if exchange:
                assert len(logs["server"]) == n_solves + K
                curvature = min(logs["server"][n_solves:])
            elif curvature is None:
                curvature = 1.0
            n_grad = len(logs["tg"])
            n_up = len(logs["td"])
            got = ttr.run_round(**draws)
            tgrads = logs["tg"][n_grad:]
            if grad_codec is ttr.uplink_codec and exchange:
                tgrads = logs["td"][n_up:-1]
            cases.append(RoundCase(
                algorithm, preset, r + 1, got, want,
                1 / min(1.0, curvature),
                tuple(ec_kw.get("linear_weights") or (0.5, 0.5))
                if algorithm == "linear" else None,
                jtr._delta_spec, jd["up"], jd["grad"],
                _flat(jb), logs["tb"][-1][0], logs["jd"][-1][0],
                logs["td"][-1], tgrads,
                _flat(jtr.global_trainable), _flat(ttr.global_trainable),
                first_residuals))
            first_residuals = [None if s is None else s.clone()
                               for s in ttr._uplink_state]
    finally:
        jfedcmoo.server_solve = server_solve
    return cases


CASES = {
    "firm_unreg_wan": ("firm_unreg", "wan", 2, {}),
    "linear_wan": ("linear", "wan", 2, {}),
    "linear_0.7_0.3_wan": ("linear", "wan", 2,
                           {"linear_weights": (0.7, 0.3)}),
    "fedcmoo_datacenter": ("fedcmoo", "datacenter", 2, {}),
    "fedcmoo_wan": ("fedcmoo", "wan", 1, {}),
    "fedcmoo_rank8_datacenter": ("fedcmoo", "datacenter", 1,
                                 {"fedcmoo_compress_rank": RANK}),
}


@pytest.fixture(scope="module")
def rounds():
    out = {}
    for name, (algorithm, preset, n_rounds, kw) in CASES.items():
        for case in _run_case(algorithm, preset, n_rounds, **kw):
            out[f"{name}_round{case.n_round}"
                + ("_carried" if case.n_round > 1 else "")] = case
    return out


def _summary_close(got, want, slack, weights=None, n_participants=C):
    assert list(got) == list(want)
    for key in EXACT_KEYS:
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["rewards_per_client"],
                                  want["rewards_per_client"])
    np.testing.assert_array_equal(got["rewards"], want["rewards"])
    assert_close(got["param_drift"], want["param_drift"], TOL, "drift")
    assert got["param_drift"] > 0
    assert abs(got["kl"] - want["kl"]) <= KL_ATOL, (got["kl"], want["kl"])
    if weights is not None:
        # linear solves nothing: lambda is the weights, exactly
        w = np.asarray(weights, np.float32)
        for s in (got, want):
            np.testing.assert_array_equal(s["lam_mean"], w)
            np.testing.assert_array_equal(
                s["per_client_lam"], np.tile(w, (n_participants, 1)))
            assert s["lam_disagreement"] == SAME_ROWS
        return
    for key in ("lam_mean", "per_client_lam", "lam_disagreement"):
        assert_close(got[key], want[key], TOL * slack, key)


def _step_close(got, want, tol, what):
    """Moves over actor_lr within ``tol`` of their scale, but for at most
    0.2% of the entries (OUTLIERS), each within 0.25 of the scale.

    Those are entries where Adam's step m_hat / (sqrt(v_hat) + eps) turns
    on the last bits of g: where the clipped combined gradient nears eps,
    because the objectives' gradients cancel in the combination (to 2e-5
    of their size) or because lora_A's gradient is still small (~1e-7)
    one step after lora_B left zero.  The two sides' gradients agree to
    ~5e-7 of their size, which the cancellation and eps / (|g| + eps)^2
    raise to ~0.1 of a step.  Measured on the CPU: linear at (0.7, 0.3)
    has 2 such entries of the clients' 28,672 in round 1 (0.105 of the
    scale) and 22 in the carried round 2 (0.071; 21 of one client's
    14,336); every other case has none.
    """
    lr = FIRMConfig().actor_lr
    g, w = _np(got) / lr, _np(want) / lr
    scale = float(np.abs(w).max())
    err = np.abs(g - w)
    out = err > tol * scale
    assert out.sum() <= OUTLIERS * err.size, \
        f"{what}: {out.sum()} entries beyond {tol} of the scale"
    assert float(err.max()) <= max(tol, 0.25) * scale, \
        f"{what}: max err {float(err.max()) / scale} of the scale"


@pytest.mark.parametrize("case", [
    "firm_unreg_wan_round1", "firm_unreg_wan_round2_carried",
    "linear_wan_round1", "linear_wan_round2_carried",
    "linear_0.7_0.3_wan_round1", "linear_0.7_0.3_wan_round2_carried",
    "fedcmoo_datacenter_round1", "fedcmoo_datacenter_round2_carried",
    "fedcmoo_wan_round1", "fedcmoo_rank8_datacenter_round1"])
def test_round_matches_jax_vectorized_round(rounds, case):
    rc = rounds[case]
    got, want = rc.got, rc.want
    _summary_close(got, want, rc.slack, rc.weights)
    exchange = rc.algorithm == "fedcmoo"
    assert got["dispatches"] == (5 + 4 * K if exchange else 6)
    up, down = CODEC_PRESETS[rc.preset]
    d = 14336
    per_client = get_algorithm(rc.algorithm).uplink_bytes_per_participant(
        dataclasses.replace(FIRMConfig(), local_steps=K, n_objectives=M),
        make_codec(up), d)
    assert got["comm_bytes"] == rc.n_round * C * (
        per_client + make_codec(down).nbytes_static(d))
    if exchange:
        # one global lambda: every row the same, no disagreement
        lam = got["per_client_lam"]
        assert (lam == lam[0]).all()
        assert got["lam_disagreement"] == want["lam_disagreement"] \
            == SAME_ROWS
    if rc.n_round == 1:
        np.testing.assert_array_equal(rc.tbroadcast, rc.jbroadcast)
    # each client's delta (the uplink codec's input) and the global's move
    (tflats, tstates), tout = rc.tdelta
    for c in range(C):
        _step_close(_np(tflats[c]), rc.jdelta[c], STEP_TOL * rc.slack,
                    f"client {c} delta")
    _step_close(rc.tglobal - rc.tbroadcast, rc.jglobal - rc.jbroadcast,
                STEP_TOL * rc.slack, "global step")
    if up != "identity":
        # the reference's delta codec on the port's input and residuals:
        # the same wire, decoded deltas and residuals, bit for bit
        if rc.n_round == 1:
            assert tstates == [] or all(s is None for s in tstates)
        else:
            assert all(torch.equal(a, b)
                       for a, b in zip(tstates, rc.carried_from))
        rpay, rstates, rdec = jmake_codec(up).roundtrip_stacked(
            jnp.asarray(_np(tflats)), rc.jspec,
            [None] * C if rc.n_round == 1 else
            [jnp.asarray(_np(s)) for s in tstates], keys=rc.up_keys)
        tpay, tres, tdec = tout
        for c in range(C):
            for name in rpay[c].arrays:
                np.testing.assert_array_equal(
                    tpay[c].arrays[name].numpy(),
                    np.asarray(rpay[c].arrays[name]),
                    err_msg=f"client {c} {name}")
            np.testing.assert_array_equal(_np(tres[c]),
                                          np.asarray(rstates[c]))
        np.testing.assert_array_equal(_np(tdec), np.asarray(rdec))
    if not exchange:
        assert rc.tgrads == []
        return
    # the gradient uplink: K stacked roundtrips of (C * M, d) client-major
    # rows, each held to the reference's gradient codec (EF stripped) on
    # the port's own input with this round's JAX keys, bit for bit
    assert len(rc.tgrads) == K
    grad_spec = "int8" if up == "int8+ef" else up
    for k, (tin, (tpay, _, tdec)) in enumerate(rc.tgrads):
        tin = tin[0] if isinstance(tin, tuple) else tin
        assert tin.shape == (C * M, d) and len(tpay) == C * M
        rpay, _, rdec = jmake_codec(grad_spec).roundtrip_stacked(
            jnp.asarray(_np(tin)), rc.jspec, keys=rc.grad_keys[k])
        for i in range(C * M):
            assert sorted(tpay[i].arrays) == sorted(rpay[i].arrays)
            assert tpay[i].nbytes == rpay[i].nbytes
            for name in rpay[i].arrays:
                np.testing.assert_array_equal(
                    tpay[i].arrays[name].numpy(),
                    np.asarray(rpay[i].arrays[name]),
                    err_msg=f"step {k} row {i} {name}")
        np.testing.assert_array_equal(_np(tdec), np.asarray(rdec))
        if up == "identity":
            assert torch.equal(tdec, tin)


def test_fedcmoo_partial_participation_matches_jax_with_its_participants():
    """C = 4 clients at participation 0.5, R = 2 ``wan`` rounds of
    ``fedcmoo``: the reference's participants and draws handed to the
    port's ``run(R, participants=)``, on the port's own state (loaded once,
    before round 1); each round held as above."""
    n_clients, n_rounds = 4, 2
    jcfg, tcfg = _cfgs()
    fields = dict(n_clients=n_clients, local_steps=K, batch_size=B,
                  n_objectives=M, participation=0.5)
    jfc = dataclasses.replace(JFIRMConfig(), **fields)
    tfc = dataclasses.replace(FIRMConfig(), **fields)
    kw = dict(algorithm="fedcmoo", prompt_len=P, max_new=MAX_NEW,
              uplink_codec="int8+ef", downlink_codec="identity")
    jtr = jengine.FederatedTrainer(jcfg, jfc, jengine.EngineConfig(**kw))
    params = bridge.to_torch(jax.tree_util.tree_map(
        np.asarray, _f32_model(jtr)), device="cpu")
    ttr = FederatedTrainer(tcfg, tfc, EngineConfig(**kw), device="cpu",
                           params=params)
    bridge.load_trainer_state(ttr, _snapshot(jtr))
    schedule = [jtr._sample_participants(round_idx=r)
                for r in range(n_rounds)]
    assert all(len(p) == 2 and p == sorted(set(p)) for p in schedule)
    server_solve, curv = jfedcmoo.server_solve, []

    def spy_solve(mats, *a, **kw):
        curv.append(_server_curvature(mats))
        return server_solve(mats, *a, **kw)
    wants, draws = [], []
    jfedcmoo.server_solve = spy_solve
    try:
        for parts in schedule:
            draws.append(_round_draws(jtr, jcfg, True, parts)[0])
            wants.append(jtr.run_round())
    finally:
        jfedcmoo.server_solve = server_solve
    assert [w["participants"] for w in wants] == schedule
    assert len(curv) == n_rounds * K
    run_round, seen = ttr.run_round, []

    def with_draws(participants=None, **kw):
        seen.append(participants)
        return run_round(participants, **draws[len(seen) - 1])
    ttr.run_round = with_draws
    gots = ttr.run(n_rounds, participants=schedule)
    assert seen == schedule and len(gots) == n_rounds
    for r, (got, want) in enumerate(zip(gots, wants)):
        slack = 1 / min(1.0, min(curv[r * K:(r + 1) * K]))
        _summary_close(got, want, slack)
        assert got["dispatches"] == 5 + 4 * K
        assert got["per_client_lam"].shape == (2, M)
    assert [ds.count for ds in ttr.datasets] == \
        [ds._count for ds in jtr.datasets]


@pytest.mark.parametrize("algorithm", ["firm_unreg", "linear", "fedcmoo"])
def test_launch_train_runs_each_algorithm_on_the_cpu(tmp_path, capsys,
                                                     algorithm):
    from repro_torch.launch import train
    out = tmp_path / "run"
    trainer = train.main(["--algorithm", algorithm, "--rounds", "1",
                          "--clients", "2", "--local-steps", "1",
                          "--batch-size", "2", "--max-new", "4",
                          "--layers", "2", "--d-model", "64", "--vocab",
                          "256", "--device", "cpu", "--out", str(out)])
    assert f"alg={algorithm}" in capsys.readouterr().out
    saved = json.loads((out / "history.json").read_text())
    hist = saved["history"]
    assert saved["config"]["algorithm"] == algorithm
    assert len(hist) == 1 and hist[0]["comm_bytes"] == trainer.ledger.total
    assert hist[0]["dispatches"] == (9 if algorithm == "fedcmoo" else 6)
    assert trainer.ledger.up_bytes == 2 * trainer.algorithm \
        .uplink_bytes_per_participant(trainer.fc, trainer.uplink_codec,
                                      trainer.d_trainable)
    assert (out / "adapters.npz").exists()
