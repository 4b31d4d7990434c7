"""The port's training path (slice 2: the FIRM local step) against the JAX
package, on the CPU at a tiny size.

Both sides get the same numpy inputs: the JAX model's parameters with
non-zero ``lora_B`` (so every adapter has a gradient), carried over by
``repro_torch.bridge``, the same batches, and JAX's own Gumbel noise for
generation.  The config is llama-3.2-1b reduced to 2 layers, d_model 64,
vocab 256, with 4 query and 2 KV heads.

Tolerances: f32 results agree within 1e-4 of the compared tensor's scale
(``|got - want| <= 1e-4 * max(1, max|want|)``): the two sides sum in other
orders.  bf16 ones within 2e-2 of the scale, the port's bf16 tolerance
(``test_torch_models.py``): bf16 rounds at other places on the two sides.
Cases that state another tolerance give the reason beside it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.core import firm as jfirm, mgda as jmgda  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import common as jcommon, transformer as jT  # noqa: E402
from repro.rlhf import critic as jcritic, kl as jkl  # noqa: E402
from repro.rlhf import local as jlocal, ppo as jppo  # noqa: E402
from repro.rlhf import rewards as jrewards  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.core import firm, mgda  # noqa: E402
from repro_torch.fed.engine import client_local_steps  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.rlhf import critic, kl, local, ppo, rewards  # noqa: E402
from repro_torch.train import optim  # noqa: E402

B, P, MAX_NEW, M = 2, 4, 8, 2
S = P + MAX_NEW
LENGTH_TOL = max(4, MAX_NEW // 2)        # the engine's choice
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 1e-4, "bf16": 2e-2}


def _cfgs():
    jcfg = dataclasses.replace(
        jax_get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                               vocab=256), n_kv_heads=2)
    tcfg = dataclasses.replace(
        get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                           vocab=256), n_kv_heads=2)
    return jcfg, tcfg


def _fcs(m=M, **kw):
    return (dataclasses.replace(JFIRMConfig(), n_objectives=m, batch_size=B,
                                **kw),
            dataclasses.replace(FIRMConfig(), n_objectives=m, batch_size=B,
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


def _params(dt="f32", seed=0, lora_b=True):
    """(JAX tree, port tree) holding the same values."""
    jcfg, _ = _cfgs()
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


def _batch(jcfg, jparams, seed=0, m=M):
    """A PPO batch made on the JAX side, as (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    mask = np.concatenate([np.zeros((B, P)), np.ones((B, MAX_NEW))],
                          1).astype(np.float32)
    mask[1, -2:] = 0.0                                  # a shorter response
    lp = np.asarray(jppo.token_logprobs(
        jT.forward_seq(jcfg, jparams, jnp.asarray(tokens))["logits"],
        jnp.asarray(tokens)), np.float32)
    old = (lp + rng.normal(0, 0.05, lp.shape) * mask).astype(np.float32)
    refl = (lp + rng.normal(0, 0.1, lp.shape) * mask).astype(np.float32)
    r = rng.uniform(0, 1, (B, m)).astype(np.float32)
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


# ------------------------------------------------------------ the kernels
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("d", [1000, 8193])
def test_gram_plain_matches_pallas_interpret(m, d):
    x = np.random.default_rng(m * d).standard_normal((m, d)).astype(
        np.float32)
    want = jops.gram(jnp.asarray(x))               # Pallas, interpret mode
    got = ref.gram(_t(x))
    assert got.dtype == torch.float32 and got.shape == (m, m)
    # sums of d products in another order: 1e-5 of the Gram's scale
    assert_close(got, want, 1e-5, "gram")
    assert_close(got, jref.gram(jnp.asarray(x)), 1e-5, "gram vs jnp")
    assert torch.equal(ops.gram(_t(x)), got)


def test_gram_from_pytrees_orders_leaves_as_jax():
    """The flattened row puts the leaves in sorted-key order: a tree whose
    dict was built in another order gives the same Gram matrix and the
    same rows as the reference's ``gram_from_pytrees``."""
    rng = np.random.default_rng(0)
    trees = [{"wq": rng.standard_normal(5).astype(np.float32),
              "wk": rng.standard_normal(3).astype(np.float32),
              "b": {"z": rng.standard_normal((2, 2)).astype(np.float32),
                    "a": None}} for _ in range(3)]
    want = jops.gram_from_pytrees(
        [jax.tree_util.tree_map(jnp.asarray, t) for t in trees],
        use_pallas=False)
    got = ops.gram_from_pytrees([bridge.to_torch(t, device="cpu")
                                 for t in trees])
    assert_close(got, want, 1e-6, "gram_from_pytrees")
    assert_close(mgda.gram_matrix([bridge.to_torch(t, device="cpu")
                                   for t in trees]),
                 jmgda.gram_matrix([jax.tree_util.tree_map(jnp.asarray, t)
                                    for t in trees]), 1e-6, "gram_matrix")


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 256), (3, 1001)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_bwd_plain_matches_jax_vjp(shape, dt):
    rng = np.random.default_rng(sum(shape))
    x, g, dy = (rng.standard_normal(s).astype(np.float32)
                for s in (shape, shape[-1:], shape))
    jx, jg, jdy = (jnp.asarray(a).astype(JDT[dt]) for a in (x, g, dy))
    _, vjp = jax.vjp(lambda a: jref.rmsnorm(a, jg), jx)
    want = vjp(jdy)[0]
    tx, tg, tdy = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if dt == "bf16" else torch.float32)
        for a in (jx, jg, jdy))
    got = ref.rmsnorm_bwd(tx, tg, tdy)
    assert got.dtype == tx.dtype
    assert_close(got, want, TOL[dt], "rmsnorm dx vs jax.vjp")
    # and against autograd of the port's own plain forward
    xa = tx.clone().requires_grad_()
    ref.rmsnorm(xa, tg).backward(tdy)
    assert_close(got, xa.grad, TOL[dt], "rmsnorm dx vs autograd")


@pytest.mark.parametrize("case", [
    # b, sq, skv, hq, hkv, dh, causal, window
    (2, 12, 12, 4, 2, 16, True, 0),
    (1, 16, 16, 4, 1, 32, False, 0),
    (1, 16, 16, 4, 2, 16, True, 5),
    (1, 9, 20, 2, 2, 16, False, 0),
], ids=["causal-gqa", "full-mqa", "window", "sq-ne-skv"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_bwd_plain_matches_jax_vjp(case, dt):
    b, sq, skv, hq, hkv, dh, causal, window = case
    rng = np.random.default_rng(sq * hq + dh)
    q = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(JDT[dt]) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, c, e: jref.flash_attention(
        a, c, e, causal=causal, sliding_window=window), jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                       .to(torch.bfloat16 if dt == "bf16" else torch.float32)
                       for a in (jq, jk, jv, jdo))
    got = ref.flash_attention_bwd(tq, tk, tv, tdo, causal=causal,
                                  sliding_window=window)
    for name, g, w, t in zip("qkv", got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert_close(g, w, TOL[dt], f"d{name}")


# ----------------------------------------------- critic, KL, rewards, GAE
def test_critic_matches_jax():
    rng = np.random.default_rng(0)
    hidden = (rng.standard_normal((B, S, 64)) * 3).astype(np.float32)
    hidden[0, 0] *= 1e-3                               # a norm under 1
    w = rng.normal(0, 2.0, (M, 64)).astype(np.float32)
    r_tok = rng.standard_normal((B, S, M)).astype(np.float32)
    mask = np.concatenate([np.zeros((B, P)), np.ones((B, MAX_NEW))],
                          1).astype(np.float32)
    jf = jcritic.features(jnp.asarray(hidden))
    tf = critic.features(_t(hidden))
    assert_close(tf, jf, 1e-6, "features")
    assert_close(critic.values({"w": _t(w)}, tf),
                 jcritic.values({"w": jnp.asarray(w)}, jf), 1e-5, "values")
    r_w = critic.r_w_bound(r_max=1.0)
    assert r_w == jcritic.r_w_bound(r_max=1.0)
    assert_close(critic.project({"w": _t(w) * 10}, r_w)["w"],
                 jcritic.project({"w": jnp.asarray(w) * 10}, r_w)["w"],
                 1e-5, "project")
    jnew, jerr = jcritic.td_update({"w": jnp.asarray(w)}, jf,
                                   jnp.asarray(r_tok), jnp.asarray(mask),
                                   0.99, 0.5, r_w)
    tnew, terr = critic.td_update({"w": _t(w)}, tf, _t(r_tok), _t(mask),
                                  0.99, 0.5, r_w)
    assert_close(tnew["w"], jnew["w"], 1e-5, "td w")
    assert_close(terr, jerr, 1e-5, "td err")
    assert critic.init_critic(M, 64, device="cpu")["w"].shape == (M, 64)


@pytest.mark.parametrize("observed", [0.0, 0.02, 0.03, 0.031, 0.5])
@pytest.mark.parametrize("coef", [1e-4, 0.1, 9.9])
def test_adaptive_kl_matches_jax(observed, coef):
    want = jkl.adaptive_kl_update(jnp.float32(coef), jnp.float32(observed),
                                  0.03)
    got = kl.adaptive_kl_update(torch.tensor(coef), torch.tensor(observed),
                                0.03)
    assert_close(got, want, 1e-6, "kl coef")


def test_shaped_rewards_and_gae_match_jax():
    rng = np.random.default_rng(1)
    kl_tok = rng.standard_normal((B + 1, S)).astype(np.float32)
    mask = np.zeros((B + 1, S), np.float32)
    mask[0, P:] = 1.0
    mask[1, P:-3] = 1.0                                  # ends early
    # row 2: no response at all (argmax over zeros picks position 0)
    term = rng.uniform(0, 1, (B + 1, M)).astype(np.float32)
    coef = np.float32(0.1)
    want = jppo.shaped_rewards(jnp.asarray(kl_tok), jnp.asarray(mask),
                               jnp.asarray(term), jnp.asarray(coef))
    got = ppo.shaped_rewards(_t(kl_tok), _t(mask), _t(term),
                             torch.tensor(coef))
    assert_close(got, want, 1e-6, "shaped rewards")
    vals = rng.standard_normal((B + 1, S, M)).astype(np.float32)
    jadv, jret = jppo.gae(want, jnp.asarray(vals), jnp.asarray(mask), 0.99,
                          0.95)
    tadv, tret = ppo.gae(got, _t(vals), _t(mask), 0.99, 0.95)
    assert_close(tadv, jadv, 1e-5, "advantages")
    assert_close(tret, jret, 1e-5, "returns")
    assert_close(ppo.masked_mean(_t(kl_tok), _t(mask)),
                 jppo.masked_mean(jnp.asarray(kl_tok), jnp.asarray(mask)),
                 1e-6, "masked mean")


# ------------------------------------------------ losses and M gradients
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_losses_and_per_objective_grads_match_jax(dt):
    jcfg, tcfg = _cfgs()
    jfc, tfc = _fcs()
    jp, tp = _params(dt)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    ttrain, tfrozen = common.split_trainable(tp)
    jb, tb = _batch(jcfg, jp)
    js, ts = _states(jtrain, jcfg.d_model)
    jgrads, jlosses, (jm, jfeats, jr, jrets, _) = jppo.per_objective_grads(
        jcfg, jfc, jtrain, jfrozen, js.critic, jb, js.kl_coef)
    tgrads, tlosses, (tm, tfeats, tr, trets, _) = ppo.per_objective_grads(
        tcfg, tfc, ttrain, tfrozen, ts.critic, tb, ts.kl_coef)
    tol = TOL[dt]
    assert tlosses.shape == (M,)
    assert_close(tlosses, jlosses, tol, "losses")
    for key in ("kl", "ratio_mean", "entropy_proxy", "aux_loss"):
        assert_close(tm[key], jm[key], tol, key)
    assert_close(tfeats, jfeats, tol, "features")
    assert_close(tr, jr, tol, "shaped rewards")
    assert_close(trets, jrets, tol, "returns")
    assert len(tgrads) == M
    for j in range(M):
        assert_trees_close(tgrads[j], jgrads[j], tol, f"grad {j}")
        # the same structure as the trainable tree, None slots included
        assert tgrads[j]["embed"] is None
        assert tgrads[j]["slots"]["0"]["attn"]["wq"]["w"] is None


# ------------------------------------------------------------------- MGDA
def _psd(seed, m):
    a = np.random.default_rng(seed).standard_normal((m, m + 2)).astype(
        np.float32)
    return a @ a.T


@pytest.mark.parametrize("v", [[0.3, 0.7], [2.0, 0.0], [-5.0, -5.0, -5.0],
                               [10.0, 0.2, 0.1], [0.4, -0.3, 1.2, 0.05]])
def test_project_simplex_matches_jax(v):
    v = np.asarray(v, np.float32)
    assert_close(mgda.project_simplex(_t(v)),
                 jmgda.project_simplex(jnp.asarray(v)), 1e-6, "projection")


@pytest.mark.parametrize("solver", ["pgd", "frank_wolfe", "closed_form_m2"])
@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("pref", [False, True])
def test_mgda_solvers_match_jax(solver, m, pref):
    if solver == "closed_form_m2" and m != 2:
        with pytest.raises(ValueError, match="M=2"):
            mgda.solve(_t(_psd(m, m)), 0.01, solver=solver)
        return
    G = _psd(m, m) * 1e-3                               # unnormalised scale
    p = (np.arange(1, m + 1, dtype=np.float32) / (m * (m + 1) / 2)
         if pref else None)
    for tn in (True, False):
        want = jmgda.solve(jnp.asarray(G), 0.01,
                           preference=None if p is None else jnp.asarray(p),
                           trace_normalize=tn, solver=solver, iters=100)
        got = mgda.solve(_t(G), 0.01, preference=None if p is None else _t(p),
                         trace_normalize=tn, solver=solver, iters=100)
        assert_close(got, want, 1e-5, f"lambda* ({solver}, tn={tn})")
        assert abs(float(got.sum()) - 1.0) < 1e-5
    assert_close(mgda.regularize(_t(G), 0.01), jmgda.regularize(
        jnp.asarray(G), 0.01), 1e-6, "regularize")


def test_resolve_and_combine_match_jax():
    rng = np.random.default_rng(3)
    trees = [{"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32),
                    "n": None}} for _ in range(3)]
    jg = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    tg = [bridge.to_torch(t, device="cpu") for t in trees]
    jfc, tfc = _fcs(m=3)
    prev = np.asarray([0.2, 0.5, 0.3], np.float32)
    for pref in (None, np.asarray([0.5, 0.3, 0.2], np.float32)):
        want = jfirm.resolve(jg, jfc, prev_lam=jnp.asarray(prev),
                             eta=jfirm.eta_schedule(jnp.asarray(3)),
                             preference=None if pref is None
                             else jnp.asarray(pref))
        got = firm.resolve(tg, tfc, prev_lam=_t(prev),
                           eta=firm.eta_schedule(torch.tensor(3)),
                           preference=None if pref is None else _t(pref))
        for name in ("lam", "lam_star", "gram"):
            assert_close(getattr(got, name), getattr(want, name), 1e-5, name)
        assert_trees_close(got.direction, want.direction, 1e-5, "direction")
        assert got.direction["b"]["n"] is None
        # the pairwise form as gram_fn gives the flat Gram's result
        pairwise = firm.resolve(tg, tfc, prev_lam=_t(prev),
                                eta=firm.eta_schedule(torch.tensor(3)),
                                gram_fn=mgda.gram_matrix,
                                preference=None if pref is None
                                else _t(pref))
        assert_close(pairwise.gram, got.gram, 1e-6, "gram_fn")
        assert_close(pairwise.lam, got.lam, 1e-6, "gram_fn lam")
    assert firm.staleness_beta(0.01, 3) == jfirm.staleness_beta(0.01, 3)
    assert_close(firm.eta_schedule(torch.tensor(0)),
                 jfirm.eta_schedule(jnp.asarray(0)), 0, "eta_0")


# ------------------------------------------------------------------- Adam
@pytest.mark.parametrize("max_norm", [None, 1.0, 1e-3])
def test_adam_update_with_clipping_matches_jax(max_norm):
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"x": rng.standard_normal(6).astype(np.float32),
                    "n": None}}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = bridge.to_torch(params, device="cpu")
    js, ts = joptim.adam_init(jp), optim.adam_init(tp)
    for step in range(3):
        g = {"w": rng.standard_normal((4, 3)).astype(np.float32),
             "b": {"x": rng.standard_normal(6).astype(np.float32),
                   "n": None}}
        jp, js, jn = joptim.adam_update(
            jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr=1e-2,
            max_grad_norm=max_norm)
        tp, ts, tn = optim.adam_update(bridge.to_torch(g, device="cpu"), ts,
                                       tp, lr=1e-2, max_grad_norm=max_norm)
        assert_close(tn, jn, 1e-6, "grad norm")
        assert int(ts.count) == int(js.count) == step + 1
        assert_trees_close(tp, jp, 1e-5, "params")
        assert_trees_close(ts.mu, js.mu, 1e-6, "mu")
        assert_trees_close(ts.nu, js.nu, 1e-6, "nu")
    assert tp["b"]["n"] is None and ts.mu["b"]["n"] is None


# -------------------------------------------------------- the local step
def _state_close(ts, js, tol, lr):
    """Every field of the port's ClientState against the JAX one."""
    # the adapters move by lr * (Adam step); the step itself is compared
    # at 100x the tolerance over lr (~1e-2 here): where |g| is near Adam's
    # eps (1e-8) the step m / (sqrt(v) + eps) is sensitive to the last
    # bits of g.
    assert_trees_close(ts.trainable, js.trainable, tol, "adapters")
    assert_trees_close(ts.opt.mu, js.opt.mu, tol, "adam mu")
    assert_trees_close(ts.opt.nu, js.opt.nu, tol, "adam nu")
    assert int(ts.opt.count) == int(js.opt.count)
    assert_close(ts.critic["w"], js.critic["w"], tol, "critic")
    assert_close(ts.lam, js.lam, tol, "lam")
    assert_close(ts.kl_coef, js.kl_coef, tol, "kl_coef")
    assert int(ts.step) == int(js.step)
    assert ts.step.dtype == torch.int32


def test_firm_local_step_matches_jax():
    jcfg, tcfg = _cfgs()
    jfc, tfc = _fcs()
    jp, tp = _params("f32")
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    jb, tb = _batch(jcfg, jp, seed=5)
    js, ts = _states(jtrain, jcfg.d_model)
    jnew, jm = jlocal.firm_local_step(jcfg, jfc, js, jfrozen, jb)
    tnew, tm = local.firm_local_step(tcfg, tfc, ts, tfrozen, tb)
    assert isinstance(tnew, local.ClientState)
    assert set(tm) == set(jm) == {
        "kl", "ratio_mean", "entropy_proxy", "aux_loss", "losses", "lam",
        "lam_star", "gram", "grad_norm", "td_err", "rewards"}
    for key in jm:
        assert_close(tm[key], jm[key], 1e-4, key)
    _state_close(tnew, jnew, 1e-4, tfc.actor_lr)
    old = common.tree_leaves(ts.trainable)
    steps = [(n - o) / tfc.actor_lr
             for n, o in zip(common.tree_leaves(tnew.trainable), old)]
    jsteps = [(np.asarray(n) - np.asarray(o)) / jfc.actor_lr for n, o in
              zip(jax.tree_util.tree_leaves(jnew.trainable),
                  jax.tree_util.tree_leaves(js.trainable))]
    for i, (a, b) in enumerate(zip(steps, jsteps)):
        assert_close(a, b, 1e-2, f"Adam step {i}")


def test_two_client_local_steps_match_jax_sequence():
    """client_local_steps == K = 2 rounds of the JAX engine's one_client
    body (generate, score_batch_banded, reference logprobs,
    firm_local_step), with injected prompts and Gumbel noise."""
    jcfg, tcfg = _cfgs()
    jfc, tfc = _fcs(local_steps=2)
    jp, tp = _params("f32", seed=1)
    jref_p, tref_p = _params("f32", seed=1, lora_b=False)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    js, ts = _states(jtrain, jcfg.d_model, seed=2)
    prompts = np.random.default_rng(9).integers(
        0, jcfg.vocab, (2, B, P)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    jh, jx = jrewards.variant_bands(jcfg.vocab, "alt")
    th, tx = rewards.variant_bands(tcfg.vocab, "alt")

    want = {"lam": [], "rewards": [], "kl": []}
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
    assert tm["lam"].shape == (2, M) and tm["rewards"].shape == (2, M)
    assert tm["kl"].shape == (2,)
    for key, vals in want.items():
        assert_close(tm[key], jnp.stack(vals), 1e-4, key)
    _state_close(tfinal, js, 1e-4, tfc.actor_lr)
    with pytest.raises(ValueError, match="exactly one"):
        client_local_steps(tcfg, tfc, ts, tfrozen, tref_p, th, tx,
                           k_steps=1, max_new=MAX_NEW, length_tol=LENGTH_TOL,
                           gumbel=_t(gumbel))
