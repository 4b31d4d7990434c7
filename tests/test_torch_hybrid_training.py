"""FIRM training on the port's zamba2 hybrid against the JAX package, on the
CPU at a tiny size: the local step, K local steps, the ``wan`` round over
three carried rounds, the flat delta's leaf order, the full-width round's
wire bytes and the training CLI.

The config is ``get_config("zamba2-1.2b").reduced(n_layers=2, d_model=64,
vocab=64)`` (one period of the 19-slot pattern: 16 Mamba2 and 3 shared
attention slots, 2 SSM heads of 64, ds 16) with ``ssm_chunk`` 16 on both
sides, so that the scan's gradients cross chunks: S = 8 + 12 = 20 is a
chunk of 16 and a ragged one of 4.  Both sides get the same numpy inputs:
the JAX model's parameters (f32, non-zero ``lora_B`` on the shared block's
adapters, its only ones) carried over by ``repro_torch.bridge``, the same
batches, prompts and JAX's own Gumbel noise and rounding bits.  On the CPU
the port differentiates its plain versions (``ref.ssd_chunked`` among
them) with autograd.

The rounds use the pattern ``("mamba2", "shared_attn", "mamba2")``
(``dataclasses.replace``, both sides): the reference's jit of a vectorized
round over the 19 slots dominates the file's time on the CPU, and three
slots keep a
Mamba2 layer before the shared block (no gradient) and one after it (its
input gradient).

Tolerances, as ``test_torch_training.py`` and ``test_torch_round.py`` hold
llama.  f32 results within 1e-4 of the compared tensor's scale (``|got -
want| <= 1e-4 * max(1, max|want|)``); the adapters' Adam steps within 1e-2
(where |g| is near Adam's eps the step is sensitive to the last bits of
g).  bf16 gradients by the f32 rule of ``test_torch_hybrid.py``: the
port's bf16 result as close to the f32 model's as the reference's bf16
result is, within 25% on the mean and the root-mean-square error, pooled
over the leaves.  The rounds: bytes, participants, tokens and rewards
exact; drift 1e-4 of its scale; KL 1e-6 absolute; lambda 1e-4 and the
clients' and the global's steps 1e-2, each over min(1, D), D the
curvature of the regularised MGDA problem at the round's worst step (the
module docstring of ``test_torch_round.py`` says why); the uplink on the
port's codec input bit for bit against the reference's codec.
"""
import dataclasses
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comms import make_codec as jmake_codec  # noqa: E402
from repro.comms import codec as jcodec  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.core import comms as jcomms  # noqa: E402
from repro.data.partition import sample_prompt_block  # noqa: E402
from repro.fed import engine as jengine  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.rlhf import local as jlocal  # noqa: E402
from repro.rlhf import ppo as jppo, rewards as jrewards  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
from repro_torch import bridge, trees  # noqa: E402
from repro_torch.comms import codec as codec_lib, make_codec  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.core import comms  # noqa: E402
from repro_torch.fed.engine import (EngineConfig, FederatedTrainer,  # noqa
                                    client_local_steps)
from repro_torch.models import common  # noqa: E402
from repro_torch.rlhf import local, ppo, rewards  # noqa: E402

ARCH = "zamba2-1.2b"
B, P, MAX_NEW, M = 2, 8, 12, 2
S = P + MAX_NEW
CHUNK = 16
LENGTH_TOL = max(4, MAX_NEW // 2)        # the engine's choice
ROUND_PATTERN = ("mamba2", "shared_attn", "mamba2")
C, ROUNDS = 2, 3                         # the round: clients, carried rounds
TOL, STEP_TOL, KL_ATOL = 1e-4, 1e-2, 1e-6
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# comm_bytes of one wan round (int8+ef up, identity down) of two clients on
# zamba2-1.2b at full width (262,144 adapter parameters), as the
# reference's ledger counts it (test below); chip_smoke.py's round_hybrid
# phase holds the card's round to it
ZAMBA2_WAN_COMM_BYTES = 2_623_488


def _cfgs(pattern=None):
    """(JAX config, port config): the reduced zamba2 with chunk 16, or
    with ``pattern`` in place of the 19 slots."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = dataclasses.replace(
            get(ARCH).reduced(n_layers=2, d_model=64, vocab=64),
            ssm_chunk=CHUNK)
        if pattern is not None:
            cfg = dataclasses.replace(cfg, pattern=pattern,
                                      n_layers=len(pattern))
        out.append(cfg)
    return tuple(out)


def _fcs(**kw):
    return (dataclasses.replace(JFIRMConfig(), n_objectives=M, batch_size=B,
                                **kw),
            dataclasses.replace(FIRMConfig(), n_objectives=M, batch_size=B,
                                **kw))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_close(got, want, tol, what=""):
    """|got - want| <= tol * max(1, max|want|), element for element."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    limit = tol * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def assert_of_scale(got, want, tol, what=""):
    """|got - want| <= tol * max|want|, element for element."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    limit = tol * (float(np.abs(w).max()) if w.size else 0.0)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def assert_trees_close(got, want, tol, what=""):
    """A port tree against a JAX tree: leaves in sorted-key order."""
    gl, wl = common.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert_close(g, w, tol, f"{what} leaf {i}")


def _with_lora_b(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                    if k == "lora_B" else _with_lora_b(v, rng))
                for k, v in tree.items()}
    return tree


def _params(jcfg, dt="f32", seed=0, lora_b=True):
    """(JAX tree, port tree) holding the same values."""
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(seed),
                                   dtype=JDT[dt]))
    if lora_b:
        tree = _with_lora_b(tree, np.random.default_rng(seed))
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        bridge.to_torch(tree, device="cpu")


def _gumbel(key, n: int, shape) -> np.ndarray:
    """The noise ``n`` successive jax.random.categorical draws add."""
    return np.stack([np.asarray(jax.random.gumbel(k, shape))
                     for k in jax.random.split(key, n)])


def _batch(jcfg, jparams, seed=0):
    """A PPO batch made on the JAX side, as (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    mask = np.concatenate([np.zeros((B, P)), np.ones((B, MAX_NEW))],
                          1).astype(np.float32)
    mask[1, -3:] = 0.0                                  # a shorter response
    lp = np.asarray(jppo.token_logprobs(
        jT.forward_seq(jcfg, jparams, jnp.asarray(tokens))["logits"],
        jnp.asarray(tokens)), np.float32)
    old = (lp + rng.normal(0, 0.05, lp.shape) * mask).astype(np.float32)
    refl = (lp + rng.normal(0, 0.1, lp.shape) * mask).astype(np.float32)
    r = rng.uniform(0, 1, (B, M)).astype(np.float32)
    arrays = (tokens, mask, old, refl, r)
    return (jppo.PPOBatch(*map(jnp.asarray, arrays)),
            ppo.PPOBatch(_t(tokens).long(), *map(_t, arrays[1:])))


def _states(jtrain, d_model, seed=0):
    """The same client state on both sides, with a non-zero critic, lam and
    step so that every field of the update is exercised."""
    js = jlocal.init_client_state(jtrain, M, d_model, kl_coef=0.1)
    rng = np.random.default_rng(seed)
    js = js._replace(
        critic={"w": jnp.asarray(rng.normal(0, 0.3, (M, d_model)),
                                 jnp.float32)},
        lam=jnp.asarray([0.3, 0.7], jnp.float32),
        step=jnp.asarray(2, jnp.int32))
    np_state = jax.tree_util.tree_map(np.asarray, js)
    return js, bridge.client_state_to_torch(np_state, device="cpu")


def _state_close(ts, js, tol):
    """Every field of the port's ClientState against the JAX one."""
    assert_trees_close(ts.trainable, js.trainable, tol, "adapters")
    assert_trees_close(ts.opt.mu, js.opt.mu, tol, "adam mu")
    assert_trees_close(ts.opt.nu, js.opt.nu, tol, "adam nu")
    assert int(ts.opt.count) == int(js.opt.count)
    assert_close(ts.critic["w"], js.critic["w"], tol, "critic")
    assert_close(ts.lam, js.lam, tol, "lam")
    assert_close(ts.kl_coef, js.kl_coef, tol, "kl_coef")
    assert int(ts.step) == int(js.step)


def _steps_close(tnew, told, jnew, jold, lr, tol, what):
    """The adapters' moves over lr (the Adam steps), leaf by leaf."""
    for i, (tn, to, jn, jo) in enumerate(zip(
            common.tree_leaves(tnew), common.tree_leaves(told),
            jax.tree_util.tree_leaves(jnew),
            jax.tree_util.tree_leaves(jold))):
        assert_close((tn - to) / lr, (np.asarray(jn) - np.asarray(jo)) / lr,
                     tol, f"{what} {i}")


# ------------------------------------------------------------ the tree
def test_trainable_tree_and_flat_delta_order_match_reference():
    """The adapters are the shared block's only (``shared`` sorts before
    ``slots``, and the slots hold none): the port's sorted-key walk and
    its flat delta lay them out as the reference's ``tree_flatten`` and
    ``comms.tree_to_flat`` do."""
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    jtrain, _ = jcommon.split_trainable(jp)
    ttrain, _ = common.split_trainable(tp)
    tleaves = common.tree_leaves(ttrain)
    jpaths = [jax.tree_util.keystr(k) for k, _ in
              jax.tree_util.tree_flatten_with_path(jtrain)[0]]
    assert len(tleaves) == len(jpaths) == 8
    assert all(p.startswith("['shared']['attn']") for p in jpaths)
    assert all(t is None for t in trees.tree_leaves(ttrain["slots"]))
    for t, j in zip(tleaves, jax.tree_util.tree_leaves(jtrain)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    tflat, tspec = codec_lib.tree_to_flat(ttrain)
    jflat, jspec = jcodec.tree_to_flat(jtrain)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    assert tspec.shapes == tuple(tuple(s) for s in jspec.shapes)
    assert trees.tree_size(ttrain) == tflat.numel()


# ------------------------------------------------------ the local step
def test_firm_local_step_matches_jax():
    jcfg, tcfg = _cfgs()
    jfc, tfc = _fcs()
    jp, tp = _params(jcfg)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    jb, tb = _batch(jcfg, jp, seed=5)
    js, ts = _states(jtrain, jcfg.d_model)
    jnew, jm = jlocal.firm_local_step(jcfg, jfc, js, jfrozen, jb)
    tnew, tm = local.firm_local_step(tcfg, tfc, ts, tfrozen, tb)
    assert set(tm) == set(jm)
    for key in jm:
        assert_close(tm[key], jm[key], TOL, key)
    _state_close(tnew, jnew, TOL)
    _steps_close(tnew.trainable, ts.trainable, jnew.trainable, js.trainable,
                 tfc.actor_lr, STEP_TOL, "Adam step")


def _pooled_errors(got, want):
    """Each leaf's |got - want| over its own max|want|, pooled."""
    return np.concatenate([np.abs(_np(g) - _np(w)).ravel()
                           / max(float(np.abs(_np(w)).max()), 1e-30)
                           for g, w in zip(got, want)])


def test_bf16_gradients_by_the_f32_rule():
    """One forward and M pulls in bf16, on four batches: the port's
    gradients as close to the f32 model's as the reference's bf16
    gradients are, the errors pooled over the batches, the objectives and
    the leaves.  One batch is not enough: a rounding difference upstream
    moves every adapter's gradient alike, so the ratio of the two bf16
    paths' distances from f32 varies by tens of percent from batch to
    batch.  On the rounds' three-slot pattern
    (a Mamba2 layer on each side of the shared block) for time."""
    jcfg, tcfg = _cfgs(ROUND_PATTERN)
    jfc, tfc = _fcs()
    jgrads = jax.jit(lambda *a: jppo.per_objective_grads(jcfg, jfc, *a)[0])
    e_got, e_ref = [], []
    for seed in range(4):
        jp, tp = _params(jcfg, "bf16", seed=20 + seed)
        jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        jb, tb = _batch(jcfg, jp32, seed=30 + seed)
        jtrain, jfrozen = jcommon.split_trainable(jp)
        ttrain, tfrozen = common.split_trainable(tp)
        _, jfrozen32 = jcommon.split_trainable(jp32)
        js, ts = _states(jtrain, jcfg.d_model, seed=seed)
        want32 = jgrads(jtrain, jfrozen32, js.critic, jb, js.kl_coef)
        want = jgrads(jtrain, jfrozen, js.critic, jb, js.kl_coef)
        got, _, _ = ppo.per_objective_grads(tcfg, tfc, ttrain, tfrozen,
                                            ts.critic, tb, ts.kl_coef)
        for j in range(M):
            w32 = jax.tree_util.tree_leaves(want32[j])
            e_got.append(_pooled_errors(common.tree_leaves(got[j]), w32))
            e_ref.append(_pooled_errors(jax.tree_util.tree_leaves(want[j]),
                                        w32))
    e_got, e_ref = np.concatenate(e_got), np.concatenate(e_ref)
    for stat, f in (("mean", np.mean),
                    ("rms", lambda e: np.sqrt(np.mean(np.square(e))))):
        g, r = float(f(e_got)), float(f(e_ref))
        assert g <= 1.25 * r, (stat, g, r)


def test_two_client_local_steps_match_jax_sequence():
    """client_local_steps == K = 2 rounds of the JAX engine's one_client
    body (generate, score_batch_banded, reference logprobs,
    firm_local_step), with injected prompts and Gumbel noise."""
    jcfg, tcfg = _cfgs()
    jfc, tfc = _fcs(local_steps=2)
    jp, tp = _params(jcfg, seed=1)
    jref_p, tref_p = _params(jcfg, seed=1, lora_b=False)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    js, ts = _states(jtrain, jcfg.d_model, seed=2)
    prompts = np.random.default_rng(9).integers(
        0, jcfg.vocab, (2, B, P)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    jh, jx = jrewards.variant_bands(jcfg.vocab, "alt")
    th, tx = rewards.variant_bands(tcfg.vocab, "alt")

    want = {"lam": [], "rewards": [], "kl": []}
    js0 = js
    for k in range(2):
        params = jcommon.merge_trainable(js.trainable, jfrozen)
        tok, lp, mask = jgenerate(jcfg, params, jnp.asarray(prompts[k]),
                                  keys[k], max_new=MAX_NEW)
        r = jrewards.score_batch_banded(jh, jx, tok, mask, M, LENGTH_TOL)
        ref_lp = jppo.token_logprobs(
            jT.forward_seq(jcfg, jref_p, tok)["logits"], tok)
        js, m = jlocal.firm_local_step(
            jcfg, jfc, js, jfrozen, jppo.PPOBatch(tok, mask, lp, ref_lp, r))
        for key in want:
            want[key].append(m[key])

    gumbel = np.stack([_gumbel(key, MAX_NEW, (B, tcfg.vocab))
                       for key in keys])
    tfinal, tm = client_local_steps(
        tcfg, tfc, ts, tfrozen, tref_p, th, tx, k_steps=2, max_new=MAX_NEW,
        length_tol=LENGTH_TOL, prompts=_t(prompts).long(),
        gumbel=_t(gumbel))
    for key, vals in want.items():
        assert_close(tm[key], jnp.stack(vals), TOL, key)
    _state_close(tfinal, js, TOL)
    _steps_close(tfinal.trainable, ts.trainable, js.trainable,
                 js0.trainable, tfc.actor_lr, STEP_TOL, "two Adam steps")


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


def _round_draws(jtr, jcfg):
    """What the next JAX round (K = 1, every client) will draw, replayed
    from its key: the port's injected draws and the JAX keys and
    prompts."""
    rng = jtr._rng

    def split(r):
        out = jax.random.split(r)
        return out[0], out[1]

    rng, down = split(rng)
    gen = []
    for _ in range(C):
        rng, kk = split(rng)
        gen.append(kk)
    up = []
    for _ in range(C):
        rng, kk = split(rng)
        up.append(kk)
    idx = jnp.arange(C, dtype=jnp.int32)
    counts0 = jnp.asarray([ds._count for ds in jtr.datasets], jnp.int32)
    prompts = np.asarray(sample_prompt_block(
        jtr._seeds_all[idx], counts0, jtr._probs_all[idx], B, P,
        jcfg.vocab))[None]                                  # (1, C, B, P)
    gumbel = np.stack([_gumbel(kk, MAX_NEW, (B, jcfg.vocab))
                       for kk in gen])[None]                # (1, C, T, B, V)
    rows = -(-jtr.d_trainable // 1024)
    bits = np.stack([np.asarray(jax.random.bits(kk, (rows, 1024),
                                                jnp.uint32)).view(np.int32)
                     for kk in up])
    draws = {"prompts": torch.from_numpy(prompts).long(),
             "gumbel": torch.from_numpy(gumbel),
             "up_bits": torch.from_numpy(bits)}
    return draws, {"prompts": prompts, "gen": gen, "up": up}


def _jit_one_client(jcfg, jfc):
    """``one_client`` of the reference's ``_make_round_fn``, jitted alone."""
    def one_client(st, prompts, key, bh, bx, frozen, ref_params):
        params = jcommon.merge_trainable(st.trainable, frozen)
        tokens, old_lp, mask = jgenerate(jcfg, params, prompts, key,
                                         max_new=MAX_NEW)
        r = jrewards.score_batch_banded(bh, bx, tokens, mask, M, LENGTH_TOL)
        ref_lp = jppo.token_logprobs(
            jT.forward_seq(jcfg, ref_params, tokens)["logits"], tokens)
        return jlocal.firm_local_step(
            jcfg, jfc, st, frozen, jppo.PPOBatch(tokens, mask, old_lp, ref_lp,
                                                 r))
    return jax.jit(one_client)


def _qp_curvature(jtr, one_client, start, prompts, gen) -> float:
    """The smallest MGDA curvature D over the round's client steps, from
    the reference's own steps run one client at a time."""
    curv = []
    for c in range(C):
        st = jtr.client_states[c]._replace(trainable=start)
        _, met = one_client(st, jnp.asarray(prompts[0, c]), gen[c],
                            jtr._bands_h[c], jtr._bands_x[c], jtr.frozen,
                            jtr.ref_params)
        g = np.asarray(met["gram"], np.float64)
        q = g / (np.trace(g) / M) + 0.5 * jtr.fc.beta * np.eye(M)
        curv.append(q[0, 0] + q[1, 1] - 2 * q[0, 1])
    return float(min(curv))


def _flat(tree, jax_side: bool) -> np.ndarray:
    leaves = (jax.tree_util.tree_leaves(tree) if jax_side
              else trees.tree_leaves(tree))
    return np.concatenate([_np(t).reshape(-1) for t in leaves])


class RoundCase(NamedTuple):
    got: dict                    # the port's summary
    want: dict                   # the JAX summary
    curvature: float
    up_keys: list                # the round's JAX uplink keys
    jspec: object                # the JAX flat TreeSpec of a delta
    broadcast: tuple             # (JAX, port) flat broadcasts
    uplink: tuple                # the port's (codec inputs, outputs)
    juplink_in: tuple            # the reference's codec inputs
    new_global: tuple            # (JAX, port) flat new globals


@pytest.fixture(scope="module")
def wan_rounds():
    """Three ``wan`` rounds of the JAX vectorized executor and of one port
    trainer loaded from the JAX trainer's state once, before round 1, and
    then carried on its own state and residuals, each round fed the JAX
    round's draws."""
    jcfg, tcfg = _cfgs(ROUND_PATTERN)
    jfc = dataclasses.replace(JFIRMConfig(), n_clients=C, local_steps=1,
                              batch_size=B, n_objectives=M)
    tfc = dataclasses.replace(FIRMConfig(), n_clients=C, local_steps=1,
                              batch_size=B, n_objectives=M)
    jtr = jengine.FederatedTrainer(jcfg, jfc, jengine.EngineConfig(
        prompt_len=P, max_new=MAX_NEW, uplink_codec="int8+ef"))
    params32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      jtr.params)
    trainable, frozen = jcommon.split_trainable(params32)
    jtr.params, jtr.ref_params, jtr.frozen = params32, params32, frozen
    jtr.global_trainable = trainable
    jtr.client_states = [jlocal.init_client_state(
        trainable, M, jcfg.d_model, jfc.kl_coef_init)
        for _ in jtr.client_states]
    ttr = FederatedTrainer(
        tcfg, tfc, EngineConfig(prompt_len=P, max_new=MAX_NEW,
                                uplink_codec="int8+ef"), device="cpu",
        params=bridge.to_torch(jax.tree_util.tree_map(np.asarray, params32),
                               device="cpu"))
    bridge.load_trainer_state(ttr, _snapshot(jtr))
    one_client = _jit_one_client(jcfg, jfc)
    jlog, tlog = [], []
    jrt = jtr.uplink_codec.roundtrip_stacked
    trt = ttr.uplink_codec.roundtrip_stacked

    def jspy(flats, spec, states, **kw):
        jlog.append((np.asarray(flats), [None if s is None else np.asarray(s)
                                         for s in states]))
        return jrt(flats, spec, states, **kw)

    def tspy(flats, spec, states, **kw):
        seen = (flats.clone(), [None if s is None else s.clone()
                                for s in states])
        out = trt(flats, spec, states, **kw)
        tlog.append((seen, out))
        return out
    jtr.uplink_codec.roundtrip_stacked = jspy
    ttr.uplink_codec.roundtrip_stacked = tspy
    cases = []
    for _ in range(ROUNDS):
        draws, jd = _round_draws(jtr, jcfg)
        jb = _flat(jtr.global_trainable, True)      # identity downlink
        tb = _flat(ttr.global_trainable, False)
        curvature = _qp_curvature(jtr, one_client, jtr.global_trainable,
                                  jd["prompts"], jd["gen"])
        want = jtr.run_round()
        got = ttr.run_round(**draws)
        cases.append(RoundCase(
            got, want, curvature, jd["up"], jtr._delta_spec, (jb, tb),
            tlog[-1], jlog[-1], (_flat(jtr.global_trainable, True),
                                 _flat(ttr.global_trainable, False))))
    return cases


@pytest.mark.parametrize("r", range(ROUNDS),
                         ids=[f"round{r + 1}" + ("" if r == 0 else "_carried")
                              for r in range(ROUNDS)])
def test_wan_rounds_match_jax_vectorized_round(wan_rounds, r):
    got, want, curvature, up_keys, jspec, (jb, tb), \
        ((tflats, tstates), tout), (jflats, jstates), (jg, tg) = \
        wan_rounds[r]
    assert list(got) == list(want)
    for key in ("comm_bytes", "up_bytes", "down_bytes", "participants",
                "dispatches", "up_nbytes", "down_nbytes", "local_steps",
                "cohorts"):
        assert got[key] == want[key], key
    d = jb.size
    assert got["comm_bytes"] == (r + 1) * C * (
        make_codec("int8+ef").nbytes_static(d)
        + make_codec("identity").nbytes_static(d))
    if r == 0:
        # anchored: the same broadcast, tokens and rewards, bit for bit
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(got["rewards_per_client"],
                                      want["rewards_per_client"])
    slack = 1 / min(1.0, curvature)
    assert_of_scale(got["param_drift"], want["param_drift"], TOL, "drift")
    assert got["param_drift"] > 0
    assert abs(got["kl"] - want["kl"]) <= KL_ATOL, (got["kl"], want["kl"])
    for key in ("lam_mean", "per_client_lam", "lam_disagreement"):
        assert_of_scale(got[key], want[key], TOL * slack, key)
    lr = FIRMConfig().actor_lr
    for c in range(C):
        assert_of_scale(_np(tflats[c]) / lr, jflats[c] / lr,
                        STEP_TOL * slack, f"client {c} delta")
    assert_of_scale((tg - tb) / lr, (jg - jb) / lr, STEP_TOL * slack,
                    "global step")
    # the residual the codec was handed: none in round 1, else the port's
    # own (carried), non-zero
    for c in range(C):
        if r == 0:
            assert tstates[c] is None and jstates[c] is None
        else:
            assert torch.equal(tstates[c], wan_rounds[r - 1].uplink[1][1][c])
    # the reference's codec on the port's input: the same wire, decoded
    # deltas and residuals, bit for bit
    rpay, rstates, rdec = jmake_codec("int8+ef").roundtrip_stacked(
        jnp.asarray(_np(tflats)), jspec,
        [None if s is None else jnp.asarray(_np(s)) for s in tstates],
        keys=up_keys)
    tpay, tres, tdec = tout
    for c in range(C):
        for name in rpay[c].arrays:
            np.testing.assert_array_equal(
                tpay[c].arrays[name].numpy(),
                np.asarray(rpay[c].arrays[name]),
                err_msg=f"client {c} {name}")
        np.testing.assert_array_equal(_np(tres[c]), np.asarray(rstates[c]))
    np.testing.assert_array_equal(_np(tdec), np.asarray(rdec))


def test_full_width_wan_round_bytes_through_the_reference_ledger():
    """comm_bytes of one ``wan`` round of two clients on zamba2-1.2b at
    full width, through the reference's codecs and ledger (on zero
    adapters of the full model's shapes): the value the card's
    round_hybrid phase is held to."""
    jcfg = jax_get_config(ARCH)
    shapes = jax.eval_shape(lambda: jT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    jtrain, _ = jcommon.split_trainable(shapes)
    jtrain = jax.tree_util.tree_map(
        lambda s: None if s is None else jnp.zeros(s.shape, jnp.float32),
        jtrain, is_leaf=lambda s: s is None)
    flat, spec = jcodec.tree_to_flat(jtrain)
    assert flat.shape == (262_144,)
    ledger = jcomms.CommsLedger()
    down, _, _ = jmake_codec("identity").roundtrip(
        jtrain, None, key=jax.random.PRNGKey(1))
    ups, _, _ = jmake_codec("int8+ef").roundtrip_stacked(
        jnp.stack([flat] * C), spec, [None] * C,
        keys=list(jax.random.split(jax.random.PRNGKey(2), C)))
    for c in range(C):
        ledger.send_down(down)
    for c in range(C):
        ledger.send_up(ups[c])
    ledger.next_round()
    assert ledger.total == ZAMBA2_WAN_COMM_BYTES
    # the port's codecs count the same bytes for the same width
    tledger = comms.CommsLedger()
    tflat = torch.zeros(262_144)
    _, tspec = codec_lib.tree_to_flat({"a": tflat})
    tup, _, _ = make_codec("int8+ef").roundtrip_stacked(
        torch.stack([tflat] * C), tspec, [None] * C,
        bits=torch.zeros((C, 256, 1024), dtype=torch.int32))
    tdown, _, _ = make_codec("identity").roundtrip({"a": tflat})
    for c in range(C):
        tledger.send_down(tdown)
    for c in range(C):
        tledger.send_up(tup[c])
    assert tledger.total == ZAMBA2_WAN_COMM_BYTES


def test_launch_train_runs_zamba2_on_the_cpu(tmp_path, capsys):
    import json
    from repro_torch.launch import train
    trainer = train.main(["--arch", ARCH, "--device", "cpu", "--rounds",
                          "1", "--clients", "2", "--local-steps", "1",
                          "--batch-size", "2", "--max-new", "4", "--out",
                          str(tmp_path)])
    assert "zamba2-1.2b-smoke" in capsys.readouterr().out
    hist = json.loads((tmp_path / "history.json").read_text())["history"]
    assert len(hist) == 1 and (tmp_path / "adapters.npz").exists()
    assert hist[0]["param_drift"] > 0
    assert trainer.d_trainable == trees.tree_size(trainer.global_trainable)
