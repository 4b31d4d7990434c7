"""The port's MoE FFN and FIRM training of the reduced mixtral against the
JAX package, on the CPU at a tiny size: ``moe_ffn`` (output, router loss,
capacity and drops, gradients, bf16), the configs' parameter counts, the
full-width mixtral plan, the local step, three carried ``wan`` rounds and
the CLIs.

``moe_ffn`` runs at mixtral's own routing (8 experts, top 2) with d_model
64 and d_ff 128, B = 2 rows of S = 64 tokens that share a direction (which
skews the routing): capacity factor 8 keeps every choice, 1.25 (the
config's: 24 slots an expert for 128 choices) and 0.5 (8 slots) drop
some, which the tests count.  The model is
``get_config("mixtral-8x7b").reduced(n_layers=2, d_model=64, vocab=64)``
(4 experts top-2, 4 heads of 16) with the window set to 8 (``reduced()``
keeps 128, longer than the S = 8 + 12 of a rollout), on both sides.  Both
sides get the same numpy inputs and the JAX model's parameters (f32,
non-zero ``lora_B``) carried over by ``repro_torch.bridge``, and the
rounds JAX's own prompts, Gumbel noise and rounding bits.

Tolerances: ``moe_ffn`` in f32 within 1e-5 of the compared tensor's scale
(``|got - want| <= 1e-5 * max(1, max|want|)``), its gradients the same;
bf16 by the f32 rule (the port's bf16 output as close to the f32 output
as the reference's bf16 output is, mean and root-mean-square within 25%,
pooled over draws: a last-bit difference may flip a routing choice on
either side).  The local step and the rounds as ``test_torch_round.py``
and ``test_torch_hybrid_training.py`` hold them: f32 results within 1e-4
of the scale, Adam steps 1e-2; the rounds' bytes, participants, tokens and
rewards exact, drift 1e-4 of its scale, KL 1e-6 absolute, lambda 1e-4 and
the steps 1e-2, each over min(1, D), D the MGDA curvature of the round's
worst step.
"""
import dataclasses
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.data.partition import sample_prompt_block  # noqa: E402
from repro.fed import api as japi  # noqa: E402
from repro.fed import engine as jengine  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.rlhf import local as jlocal  # noqa: E402
from repro.rlhf import ppo as jppo, rewards as jrewards  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
from repro_torch import bridge, trees  # noqa: E402
from repro_torch.configs import (FIRMConfig, list_archs,  # noqa: E402
                                 get_config)
from repro_torch.fed import api  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.models import common, moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.rlhf import local, ppo  # noqa: E402

ARCH = "mixtral-8x7b"
B, P, MAX_NEW, M = 2, 8, 12, 2
S = P + MAX_NEW
WINDOW = 8
LENGTH_TOL = max(4, MAX_NEW // 2)        # the engine's choice
C, ROUNDS = 2, 3
TOL, STEP_TOL, KL_ATOL = 1e-4, 1e-2, 1e-6
FFN_TOL = 1e-5
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# LoRA parameters of mixtral-8x7b at 4 layers (wq, wk, wv, wo at rank 16)
MIXTRAL_4L_TRAINABLE = 1_703_936


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
    gl, wl = common.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert_close(g, w, tol, f"{what} leaf {i}")


# ------------------------------------------------------------ moe_ffn
def _ffn_cfgs(capacity_factor=1.25, top_k=2):
    """Mixtral's routing (8 experts) at d_model 64, d_ff 128."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = dataclasses.replace(get(ARCH), d_model=64, d_ff=128)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor, top_k=top_k)))
    return tuple(out)


def _ffn_inputs(jcfg, dt="f32", seed=0, shape=(2, 64)):
    """(JAX params, port params, JAX x, port x) with the same values."""
    p = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(seed), jcfg, dtype=JDT[dt]))
    rng = np.random.default_rng(seed)
    # a direction shared by every token skews the routing, so that the
    # config's capacity factor drops choices
    x = (rng.standard_normal(shape + (jcfg.d_model,), dtype=np.float32)
         + rng.standard_normal(jcfg.d_model, dtype=np.float32))
    return (jax.tree_util.tree_map(jnp.asarray, p),
            bridge.to_torch(p, device="cpu"),
            jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt]))


def _dropped(cfg, p, x) -> int:
    """Choices past their expert's capacity, counted in numpy."""
    logits = np.asarray(x, np.float32) @ np.asarray(p["router"]["w"])
    ids = np.argsort(-logits, -1)[..., :cfg.moe.top_k]     # (B, S, k)
    cap = moe.capacity(cfg, x.shape[1])
    return sum(max(0, int((ids[b] == e).sum()) - cap)
               for b in range(ids.shape[0])
               for e in range(cfg.moe.n_experts))


@pytest.mark.parametrize("cf,drops", [(8.0, False), (1.25, True),
                                      (0.5, True)])
def test_moe_ffn_matches_jax(cf, drops):
    jcfg, tcfg = _ffn_cfgs(cf)
    jp, tp, jx, tx = _ffn_inputs(jcfg, seed=1)
    jy, jaux = jmoe.moe_ffn(jp, jcfg, jx)
    ty, taux = moe.moe_ffn(tp, tcfg, tx)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    assert_close(ty, jy, FFN_TOL, "y")
    assert_close(taux, jaux, FFN_TOL, "aux")
    assert (_dropped(tcfg, jp, jx) > 0) == drops
    assert moe.capacity(tcfg, 64) == {8.0: 128, 1.25: 24, 0.5: 8}[cf]


def test_capacity_is_the_references():
    """80 slots at the update's S = 256, 40 at a prefill of 128 and 8 in a
    decode step, for mixtral-8x7b; ``_round_up`` as the reference's."""
    cfg = get_config(ARCH)
    assert [moe.capacity(cfg, s) for s in (256, 128, 1)] == [80, 40, 8]
    for x, m in ((0, 8), (1, 8), (8, 8), (9, 8), (77, 16)):
        assert moe._round_up(x, m) == jmoe._round_up(x, m)


def test_moe_topk1_matches_dense_expert():
    """``test_models.py``'s case: top 1 with ample capacity gives each
    token its selected expert's SwiGLU output."""
    jcfg, tcfg = _ffn_cfgs(8.0, top_k=1)
    _, tp, _, tx = _ffn_inputs(jcfg, seed=2, shape=(2, 8))
    y, aux = moe.moe_ffn(tp, tcfg, tx)
    xf = tx.reshape(-1, tcfg.d_model)
    eid = (xf @ tp["router"]["w"]).argmax(-1)
    w = tp["experts"]
    for t in range(xf.shape[0]):
        e = int(eid[t])
        h = torch.nn.functional.silu(xf[t] @ w["w_gate"][e]) * (
            xf[t] @ w["w_up"][e])
        assert_close(y.reshape(-1, tcfg.d_model)[t], h @ w["w_down"][e],
                     FFN_TOL, f"token {t}")
    assert float(aux) >= 0.0


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_ffn_gradients_match_jax_grad(cf):
    """d/d(x, router, experts) of sum(y^2) + aux against ``jax.grad``."""
    jcfg, tcfg = _ffn_cfgs(cf)
    jp, tp, jx, tx = _ffn_inputs(jcfg, seed=3, shape=(1, 32))

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, jcfg, x)
        return (y ** 2).sum() + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = [t.requires_grad_() for t in trees.tree_leaves(tp)]
    tx.requires_grad_()
    y, aux = moe.moe_ffn(tp, tcfg, tx)
    grads = torch.autograd.grad((y ** 2).sum() + aux, leaves + [tx])
    assert_close(grads[-1], jgx, FFN_TOL, "dx")
    for i, (g, w) in enumerate(zip(grads[:-1],
                                   jax.tree_util.tree_leaves(jgp))):
        assert_close(g, w, FFN_TOL, f"param leaf {i}")
    assert float(jnp.abs(jgp["router"]["w"]).max()) > 0


def test_moe_ffn_bf16_by_the_f32_rule():
    """bf16 outputs pooled over four draws (capacity factor 1.25)."""
    jcfg, tcfg = _ffn_cfgs(1.25)
    e_got, e_ref = [], []
    for seed in range(4):
        jp, tp, jx, tx = _ffn_inputs(jcfg, "bf16", seed=10 + seed)
        jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        want32 = _np(jmoe.moe_ffn(jp32, jcfg, jx.astype(jnp.float32))[0])
        want = _np(jmoe.moe_ffn(jp, jcfg, jx)[0])
        got_y, got_aux = moe.moe_ffn(tp, tcfg, tx)
        assert got_y.dtype == torch.bfloat16
        e_got.append(np.abs(_np(got_y) - want32).ravel())
        e_ref.append(np.abs(want - want32).ravel())
    e_got, e_ref = np.concatenate(e_got), np.concatenate(e_ref)
    for stat, f in (("mean", np.mean),
                    ("rms", lambda e: np.sqrt(np.mean(np.square(e))))):
        g, r = float(f(e_got)), float(f(e_ref))
        assert g <= 1.25 * r, (stat, g, r)


# -------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_config_and_param_count_match_reference(arch):
    jfull, tfull = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(jfull) == dataclasses.asdict(tfull)
    jred, tred = (c.reduced(n_layers=2, d_model=64, vocab=64)
                  for c in (jfull, tfull))
    assert dataclasses.asdict(jred) == dataclasses.asdict(tred)
    for j, t in ((jfull, tfull), (jred, tred)):
        assert t.param_count() == j.param_count()
        assert t.param_count(active_only=True) == \
            j.param_count(active_only=True)
    if tfull.moe is not None:
        assert (tred.moe.n_experts, tred.moe.top_k) == (
            min(4, tfull.moe.n_experts), min(2, tfull.moe.top_k))
    if tfull.head_dim == 128:
        assert tfull.head_dim == tfull.d_model // tfull.n_heads


def test_mixtral_at_four_layers_counts():
    """The depth the card runs: 1,451,270,144 parameters a layer (so 46.7 B
    at 32 layers), 6.07 B at 4, and the adapters' 1,703,936."""
    cfg = get_config(ARCH)
    four = dataclasses.replace(cfg, n_layers=4, n_periods=4)
    per_layer = (cfg.param_count() - four.param_count()) // 28
    assert per_layer == 1_451_270_144
    assert four.param_count() == 6_067_228_672
    assert api.trainable_size(four) == MIXTRAL_4L_TRAINABLE


def test_full_width_mixtral_plan_matches_jax_on_the_meta_device(monkeypatch):
    """The plan of the card's ``moe`` phase (mixtral-8x7b at 4 layers,
    ``wan``, C = 2, K = 1, R = 2), built on the meta device, equal to the
    JAX planner's summary."""
    seen = []
    init = T.init_params

    def spy(cfg, **kw):
        params = init(cfg, **kw)
        seen.append({t.device.type for t in trees.tree_leaves(params)})
        return params
    monkeypatch.setattr(T, "init_params", spy)
    api.trainable_size.cache_clear()
    specs = []
    for port in (True, False):
        cfg = dataclasses.replace((get_config if port else jax_get_config)(
            ARCH), n_layers=4, n_periods=4)
        fc = (FIRMConfig if port else JFIRMConfig)(
            n_objectives=2, n_clients=2, local_steps=1, batch_size=16)
        ec = (api.EngineConfig if port else japi.EngineConfig)(
            uplink_codec="int8+ef", downlink_codec="identity", max_new=128,
            prompt_len=128)
        specs.append((api if port else japi).RunSpec(
            model=cfg, firm=fc, engine=ec, rounds=2))
    got = api.plan(specs[0]).summary()
    assert seen == [{"meta"}]
    assert got == japi.plan(specs[1]).summary()
    assert got["d_trainable"] == MIXTRAL_4L_TRAINABLE
    assert (got["up_bytes_per_round"], got["down_bytes_per_round"]) == (
        3_421_184, 13_631_488)


# ------------------------------------------------------ training, the round
def _cfgs():
    out = []
    for get in (jax_get_config, get_config):
        out.append(dataclasses.replace(
            get(ARCH).reduced(n_layers=2, d_model=64, vocab=64),
            sliding_window=WINDOW))
    return tuple(out)


def _fcs(**kw):
    return (dataclasses.replace(JFIRMConfig(), n_objectives=M, batch_size=B,
                                **kw),
            dataclasses.replace(FIRMConfig(), n_objectives=M, batch_size=B,
                                **kw))


def _with_lora_b(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                    if k == "lora_B" else _with_lora_b(v, rng))
                for k, v in tree.items()}
    return tree


def _params(jcfg, dt="f32", seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(seed),
                                   dtype=JDT[dt]))
    tree = _with_lora_b(tree, np.random.default_rng(seed))
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        bridge.to_torch(tree, device="cpu")


def _batch(jcfg, jparams, seed=0):
    """A PPO batch made on the JAX side, as (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    mask = np.concatenate([np.zeros((B, P)), np.ones((B, MAX_NEW))],
                          1).astype(np.float32)
    mask[1, -3:] = 0.0
    lp = np.asarray(jppo.token_logprobs(
        jT.forward_seq(jcfg, jparams, jnp.asarray(tokens))["logits"],
        jnp.asarray(tokens)), np.float32)
    old = (lp + rng.normal(0, 0.05, lp.shape) * mask).astype(np.float32)
    refl = (lp + rng.normal(0, 0.1, lp.shape) * mask).astype(np.float32)
    r = rng.uniform(0, 1, (B, M)).astype(np.float32)
    arrays = (tokens, mask, old, refl, r)
    return (jppo.PPOBatch(*map(jnp.asarray, arrays)),
            ppo.PPOBatch(_t(tokens).long(), *map(_t, arrays[1:])))


def test_firm_local_step_matches_jax():
    """One FIRM update on the reduced mixtral (the router loss in the
    losses, the window biting at S = 20): metrics, the new client state
    and the Adam steps."""
    jcfg, tcfg = _cfgs()
    jfc, tfc = _fcs()
    jp, tp = _params(jcfg)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    jb, tb = _batch(jcfg, jp, seed=5)
    js = jlocal.init_client_state(jtrain, M, jcfg.d_model, kl_coef=0.1)
    rng = np.random.default_rng(0)
    js = js._replace(critic={"w": jnp.asarray(rng.normal(0, 0.3, (
        M, jcfg.d_model)), jnp.float32)},
        lam=jnp.asarray([0.3, 0.7], jnp.float32),
        step=jnp.asarray(2, jnp.int32))
    ts = bridge.client_state_to_torch(jax.tree_util.tree_map(np.asarray, js),
                                      device="cpu")
    jnew, jm = jlocal.firm_local_step(jcfg, jfc, js, jfrozen, jb)
    tnew, tm = local.firm_local_step(tcfg, tfc, ts, tfrozen, tb)
    assert set(tm) == set(jm)
    for key in jm:
        assert_close(tm[key], jm[key], TOL, key)
    assert float(tm["aux_loss"]) > 0
    assert_trees_close(tnew.trainable, jnew.trainable, TOL, "adapters")
    assert_trees_close(tnew.opt.mu, jnew.opt.mu, TOL, "adam mu")
    assert_trees_close(tnew.opt.nu, jnew.opt.nu, TOL, "adam nu")
    assert_close(tnew.critic["w"], jnew.critic["w"], TOL, "critic")
    assert_close(tnew.lam, jnew.lam, TOL, "lam")
    lr = tfc.actor_lr
    for i, (tn, to, jn, jo) in enumerate(zip(
            common.tree_leaves(tnew.trainable),
            common.tree_leaves(ts.trainable),
            jax.tree_util.tree_leaves(jnew.trainable),
            jax.tree_util.tree_leaves(js.trainable))):
        assert_close((tn - to) / lr, (np.asarray(jn) - np.asarray(jo)) / lr,
                     STEP_TOL, f"Adam step {i}")


def _gumbel(key, n: int, shape) -> np.ndarray:
    return np.stack([np.asarray(jax.random.gumbel(k, shape))
                     for k in jax.random.split(key, n)])


def _snapshot(jtr) -> dict:
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"global_trainable": host(jtr.global_trainable),
            "client_states": [host(s) for s in jtr.client_states],
            "uplink_state": [None if r is None else np.asarray(r)
                             for r in jtr._uplink_state],
            "prompt_counts": [ds._count for ds in jtr.datasets]}


def _round_draws(jtr, jcfg):
    """What the next JAX round (K = 1, every client) will draw."""
    rng = jtr._rng

    def split(r):
        out = jax.random.split(r)
        return out[0], out[1]

    rng, down = split(rng)
    gen, up = [], []
    for _ in range(C):
        rng, kk = split(rng)
        gen.append(kk)
    for _ in range(C):
        rng, kk = split(rng)
        up.append(kk)
    idx = jnp.arange(C, dtype=jnp.int32)
    counts0 = jnp.asarray([ds._count for ds in jtr.datasets], jnp.int32)
    prompts = np.asarray(sample_prompt_block(
        jtr._seeds_all[idx], counts0, jtr._probs_all[idx], B, P,
        jcfg.vocab))[None]
    gumbel = np.stack([_gumbel(kk, MAX_NEW, (B, jcfg.vocab))
                       for kk in gen])[None]
    rows = -(-jtr.d_trainable // 1024)
    bits = np.stack([np.asarray(jax.random.bits(kk, (rows, 1024),
                                                jnp.uint32)).view(np.int32)
                     for kk in up])
    return ({"prompts": torch.from_numpy(prompts).long(),
             "gumbel": torch.from_numpy(gumbel),
             "up_bits": torch.from_numpy(bits)},
            {"prompts": prompts, "gen": gen})


def _qp_curvature(jtr, jcfg, jfc, start, prompts, gen) -> float:
    """The smallest MGDA curvature D over the round's client steps."""
    def one_client(st, prompts, key, bh, bx, frozen, ref_params):
        params = jcommon.merge_trainable(st.trainable, frozen)
        tokens, old_lp, mask = jgenerate(jcfg, params, prompts, key,
                                         max_new=MAX_NEW)
        r = jrewards.score_batch_banded(bh, bx, tokens, mask, M, LENGTH_TOL)
        ref_lp = jppo.token_logprobs(
            jT.forward_seq(jcfg, ref_params, tokens)["logits"], tokens)
        return jlocal.firm_local_step(
            jcfg, jfc, st, frozen, jppo.PPOBatch(tokens, mask, old_lp,
                                                 ref_lp, r))
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
    got: dict
    want: dict
    curvature: float
    broadcast: tuple             # (JAX, port) flat broadcasts
    new_global: tuple            # (JAX, port) flat new globals


@pytest.fixture(scope="module")
def wan_rounds():
    """Three ``wan`` rounds of the JAX vectorized executor and of one port
    trainer loaded from the JAX trainer's state once, before round 1, and
    then carried on its own state and residuals, each round fed the JAX
    round's draws."""
    jcfg, tcfg = _cfgs()
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
    cases = []
    for _ in range(ROUNDS):
        draws, jd = _round_draws(jtr, jcfg)
        jb = _flat(jtr.global_trainable, True)      # identity downlink
        tb = _flat(ttr.global_trainable, False)
        curvature = _qp_curvature(jtr, jcfg, jfc, jtr.global_trainable,
                                  jd["prompts"], jd["gen"])
        want = jtr.run_round()
        got = ttr.run_round(**draws)
        cases.append(RoundCase(got, want, curvature, (jb, tb),
                               (_flat(jtr.global_trainable, True),
                                _flat(ttr.global_trainable, False))))
    return cases


@pytest.mark.parametrize("r", range(ROUNDS),
                         ids=[f"round{r + 1}" + ("" if r == 0 else "_carried")
                              for r in range(ROUNDS)])
def test_wan_rounds_match_jax_vectorized_round(wan_rounds, r):
    got, want, curvature, (jb, tb), (jg, tg) = wan_rounds[r]
    assert list(got) == list(want)
    for key in ("comm_bytes", "up_bytes", "down_bytes", "participants",
                "dispatches", "up_nbytes", "down_nbytes", "local_steps",
                "cohorts"):
        assert got[key] == want[key], key
    if r == 0:
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
    assert_of_scale((tg - tb) / lr, (jg - jb) / lr, STEP_TOL * slack,
                    "global step")


# ------------------------------------------------------------------ CLIs
def test_serve_cli_runs_mixtral_on_the_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", ARCH, "--preset", "smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--max-new",
                      "6"])
    assert tuple(out.shape) == (2, 6)
    assert "mixtral-8x7b-smoke" in capsys.readouterr().out


def test_train_cli_runs_mixtral_on_the_cpu(tmp_path, capsys):
    import json
    from repro_torch.launch import train
    trainer = train.main(["--arch", ARCH, "--preset", "smoke", "--device",
                          "cpu", "--rounds", "1", "--clients", "2",
                          "--local-steps", "1", "--batch-size", "2",
                          "--max-new", "4", "--out", str(tmp_path)])
    assert "mixtral-8x7b-smoke" in capsys.readouterr().out
    hist = json.loads((tmp_path / "history.json").read_text())["history"]
    assert len(hist) == 1 and hist[0]["param_drift"] > 0
    assert trainer.d_trainable == trees.tree_size(trainer.global_trainable)
