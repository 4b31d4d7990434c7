"""The port's algorithm registry (``repro_torch.fed.algorithms``), the
FedCMOO server (``repro_torch.core.fedcmoo``) and the baselines' local
steps (``rlhf.local.fedcmoo_local_grads``, ``fedcmoo_local_apply``,
``linear_local_step``) against the JAX package, on the CPU at a tiny size.

The registry is held to the reference's field by field: names, kernels,
capabilities, the dispatch count, config resolution and the error texts.
The byte model (``uplink_bytes_per_participant``) equals the reference's
for every algorithm, codec preset and K in {1, 2}, and equals what the
port's ledger measures in one tiny round.

The server: ``flatten_grads`` and ``stack_grads_flat`` are bit for bit;
``sketch`` given JAX's normal draw agrees within 1e-6 of its scale (the
two products sum in other orders); lambda agrees within 1e-5 over min(1,
D), D the curvature of the trace-normalised problem (see
``test_torch_round.py``): the Gram matrices sum in other orders.

The local steps take the same numpy inputs on both sides (bridged client
states, one JAX batch, the llama config of ``test_torch_training.py``)
and are held to that file's tolerances: f32 results within 1e-4 of
max(1, scale), the Adam steps (moves over actor_lr) within 1e-2.
"""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comms import make_codec as jmake_codec  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import CODEC_PRESETS as JCODEC_PRESETS  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.core import fedcmoo as jfedcmoo  # noqa: E402
from repro.fed import algorithms as jalg  # noqa: E402
from repro.models import common as jcommon, transformer as jT  # noqa: E402
from repro.rlhf import local as jlocal, ppo as jppo  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.comms import make_codec  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.configs.base import CODEC_PRESETS  # noqa: E402
from repro_torch.core import fedcmoo  # noqa: E402
from repro_torch.fed import algorithms as alg  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.models import common  # noqa: E402
from repro_torch.rlhf import local, ppo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("fedcmoo", "firm", "firm_unreg", "linear")
B, P, MAX_NEW, M = 2, 4, 8, 2
S = P + MAX_NEW
D_FULL = 3_407_872          # llama-3.2-1b's LoRA parameters at full width


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
    gl, wl = common.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert_close(g, w, tol, f"{what} leaf {i}")


def _cfgs():
    jcfg = dataclasses.replace(
        jax_get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                               vocab=256), n_kv_heads=2)
    tcfg = dataclasses.replace(
        get_config("llama-3.2-1b").reduced(n_layers=2, d_model=64,
                                           vocab=256), n_kv_heads=2)
    return jcfg, tcfg


def _fcs(**kw):
    return (dataclasses.replace(JFIRMConfig(), **kw),
            dataclasses.replace(FIRMConfig(), **kw))


# ------------------------------------------------------------ the registry
def test_registry_names_and_errors_match_the_reference():
    assert alg.available_algorithms() == jalg.available_algorithms() == NAMES
    with pytest.raises(ValueError) as got:
        alg.get_algorithm("fedavg")
    with pytest.raises(ValueError) as want:
        jalg.get_algorithm("fedavg")
    assert str(got.value) == str(want.value)
    assert "unknown algorithm 'fedavg'" in str(got.value)
    for caps in (dict(fusable=True, traced_server_exchange=False),
                 dict(fusable=True, vmap_safe=False)):
        with pytest.raises(ValueError) as got:
            alg.validate_capabilities(alg.Capabilities(**caps), "x")
        with pytest.raises(ValueError) as want:
            jalg.validate_capabilities(jalg.Capabilities(**caps), "x")
        assert str(got.value) == str(want.value)
        bad = type("Bad", (alg.Algorithm,), {
            "name": "bad", "caps": alg.Capabilities(**caps)})()
        with pytest.raises(ValueError, match="fusable=True"):
            alg.register_algorithm(bad)
        assert "bad" not in alg.available_algorithms()


@pytest.mark.parametrize("name", NAMES)
def test_each_algorithm_declares_what_the_reference_does(name):
    got, want = alg.get_algorithm(name), jalg.get_algorithm(name)
    assert got.name == want.name == name
    assert got.kernel == want.kernel
    assert dataclasses.asdict(got.caps) == dataclasses.asdict(want.caps)
    assert [f.name for f in dataclasses.fields(alg.Capabilities)] == \
        [f.name for f in dataclasses.fields(jalg.Capabilities)]
    for k in (1, 2, 3):
        assert got.vec_phase_dispatches(k) == want.vec_phase_dispatches(k)
    jfc, tfc = _fcs(beta=0.05, n_clients=3,
                    client_preferences=((0.2, 0.8), (0.5, 0.5), (0.9, 0.1)))
    assert dataclasses.asdict(got.resolve_config(tfc)) == \
        dataclasses.asdict(want.resolve_config(jfc))
    assert got.resolve_config(tfc).beta == (0.0 if name == "firm_unreg"
                                            else 0.05)
    for extra in ({}, {"client_local_steps": (1, 2, 1)}):
        jfc2, tfc2 = (dataclasses.replace(f, **extra) for f in (jfc, tfc))
        assert [dataclasses.asdict(c) for c in alg.client_configs(got, tfc2)] \
            == [dataclasses.asdict(c)
                for c in jalg.client_configs(want, jfc2)]


def test_fedcmoo_rejects_any_client_local_steps():
    jfc, tfc = _fcs(n_clients=2)
    for steps in ((1, 2), (2, 2)):
        jfc2, tfc2 = (dataclasses.replace(f, client_local_steps=steps)
                      for f in (jfc, tfc))
        with pytest.raises(ValueError) as got:
            alg.get_algorithm("fedcmoo").validate(tfc2, EngineConfig())
        with pytest.raises(ValueError) as want:
            jalg.get_algorithm("fedcmoo").validate(jfc2, None)
        assert str(got.value) == str(want.value)
        # the trainer checks it before anything else
        _, tcfg = _cfgs()
        with pytest.raises(ValueError, match="homogeneous local_steps"):
            FederatedTrainer(tcfg, tfc2, EngineConfig(algorithm="fedcmoo"),
                             device="cpu")
    alg.get_algorithm("fedcmoo").validate(tfc, EngineConfig())
    for name in ("firm", "firm_unreg", "linear"):
        alg.get_algorithm(name).validate(
            dataclasses.replace(tfc, client_local_steps=(1, 2)),
            EngineConfig())


def test_engine_dispatches_on_capabilities_not_names():
    """The engine and the planner name no algorithm but EngineConfig's
    default (in ``fed/api.py``, EngineConfig's home, as in the
    reference), and an algorithm registered from outside runs without a
    change to either."""
    names = {}
    for mod in ("engine", "api"):
        src = (ROOT / f"src/repro_torch/fed/{mod}.py").read_text()
        names[mod] = [n.value for n in ast.walk(ast.parse(src))
                      if isinstance(n, ast.Constant) and n.value in NAMES]
    assert names == {"engine": [], "api": ["firm"]}
    assert 'algorithm: str = "firm"' in (
        ROOT / "src/repro_torch/fed/api.py").read_text()

    class Halved(alg.LinearAlgorithm):
        name = "halved"

        def traced_extra(self, cfc, ec, device=None):
            return 0.5 * super().traced_extra(cfc, ec, device)

    alg.register_algorithm(Halved())
    try:
        _, tcfg = _cfgs()
        _, tfc = _fcs(n_clients=2, local_steps=1, batch_size=B,
                      n_objectives=M)
        tr = FederatedTrainer(tcfg, tfc, EngineConfig(
            algorithm="halved", prompt_len=P, max_new=4), device="cpu")
        s = tr.run_round()
        np.testing.assert_array_equal(s["lam_mean"], [0.25, 0.25])
        assert s["dispatches"] == 6
    finally:
        alg._REGISTRY.pop("halved")
    assert alg.available_algorithms() == NAMES


# ----------------------------------------------------------- the byte model
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("preset", sorted(CODEC_PRESETS))
@pytest.mark.parametrize("name", NAMES)
def test_uplink_bytes_match_the_reference_and_the_ledger(name, preset, k):
    up, down = CODEC_PRESETS[preset]
    assert JCODEC_PRESETS[preset] == (up, down)
    jfc, tfc = _fcs(n_clients=2, local_steps=k, batch_size=B,
                    n_objectives=M)
    got, want = alg.get_algorithm(name), jalg.get_algorithm(name)
    _, tcfg = _cfgs()
    tr = FederatedTrainer(tcfg, tfc, EngineConfig(
        algorithm=name, prompt_len=P, max_new=4, uplink_codec=up,
        downlink_codec=down), device="cpu")
    for d in (tr.d_trainable, D_FULL):
        assert got.uplink_bytes_per_participant(tfc, make_codec(up), d) == \
            want.uplink_bytes_per_participant(jfc, jmake_codec(up), d)
    per_client = got.uplink_bytes_per_participant(tfc, tr.uplink_codec,
                                                  tr.d_trainable)
    s = tr.run_round()
    assert tr.ledger.up_bytes == 2 * per_client
    assert tr.ledger.down_bytes == 2 * make_codec(down).nbytes_static(
        tr.d_trainable)
    assert s["comm_bytes"] == tr.ledger.up_bytes + tr.ledger.down_bytes
    # the summary's up_nbytes is the delta's payload alone, as the
    # reference's is
    assert s["up_nbytes"] == [make_codec(up).nbytes_static(
        tr.d_trainable)] * 2
    assert s["dispatches"] == (5 + 4 * k if name == "fedcmoo" else 6)
    if preset == "wan":
        # llama-3.2-1b at full width, C = 2: the bytes the chip run checks
        want_bytes = {1: 10_263_552, 2: 17_105_920} if name == "fedcmoo" \
            else {1: 3_421_184, 2: 3_421_184}
        assert got.uplink_bytes_per_participant(
            tfc, make_codec(up), D_FULL) == want_bytes[k]


# ------------------------------------------------------------- the server
def _grad_trees(rng, m, lead=()):
    """M gradient trees with a None slot and a bf16 leaf, as numpy."""
    def one():
        return {"wq": rng.standard_normal(lead + (5, 3)).astype(np.float32),
                "wk": np.asarray(jnp.asarray(rng.standard_normal(
                    lead + (7,)), jnp.bfloat16)),
                "b": {"z": rng.standard_normal(lead + (2, 2)).astype(
                    np.float32), "a": None}}
    return [one() for _ in range(m)]


def test_flatten_and_stack_grads_are_bit_for_bit():
    rng = np.random.default_rng(0)
    for m in (2, 3):
        trees = _grad_trees(rng, m)
        got = fedcmoo.flatten_grads([bridge.to_torch(t, "cpu")
                                     for t in trees])
        want = jfedcmoo.flatten_grads([jax.tree_util.tree_map(
            jnp.asarray, t) for t in trees])
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        c = 3
        stacked = _grad_trees(rng, m, lead=(c,))
        got = fedcmoo.stack_grads_flat([bridge.to_torch(t, "cpu")
                                        for t in stacked], m)
        want = jfedcmoo.stack_grads_flat([jax.tree_util.tree_map(
            jnp.asarray, t) for t in stacked], m)
        assert got.shape == (c, m, 5 * 3 + 7 + 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for i in range(c):
            per = [common.tree_map(lambda x, i=i: x[i],
                                   bridge.to_torch(t, "cpu"))
                   for t in stacked]
            assert torch.equal(got[i], fedcmoo.flatten_grads(per))


def test_sketch_with_the_reference_draw():
    rng = np.random.default_rng(1)
    flat = rng.standard_normal((2, 1000)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (1000, 8), jnp.float32))
    want = jfedcmoo.sketch(jnp.asarray(flat), 8, key)
    got = fedcmoo.sketch(_t(flat), 8, noise=_t(noise))
    assert got.shape == (2, 8)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= 1e-6 * float(np.abs(np.asarray(want)).max()), err
    # a draw from a generator: the same as that draw injected
    g = torch.Generator().manual_seed(5)
    drawn = fedcmoo.sketch_noise(1000, 8, torch.Generator().manual_seed(5))
    assert torch.equal(fedcmoo.sketch(_t(flat), 8, generator=g),
                       fedcmoo.sketch(_t(flat), 8, noise=drawn))


def _curvature(mats) -> float:
    """D = Q11 + Q22 - 2 Q12 of the trace-normalised average Gram at
    beta = 0 (M = 2), in float64."""
    avg = sum(np.asarray(a, np.float64) for a in mats) / len(mats)
    g = avg @ avg.T
    q = g / (np.trace(g) / g.shape[0])
    return q[0, 0] + q[1, 1] - 2 * q[0, 1]


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("rank", [None, 8])
def test_server_lambda_matches_the_reference(c, rank):
    rng = np.random.default_rng(10 * c + (rank or 0))
    trees = [_grad_trees(rng, M) for _ in range(c)]
    # correlated objectives, so that lambda is inside the simplex
    for per in trees:
        per[1]["wq"] = (0.6 * per[0]["wq"] + per[1]["wq"]).astype(np.float32)
    jtrees = [[jax.tree_util.tree_map(jnp.asarray, t) for t in per]
              for per in trees]
    ttrees = [[bridge.to_torch(t, "cpu") for t in per] for per in trees]
    key = jax.random.PRNGKey(7)
    want = jfedcmoo.fedcmoo_round_lambda(jtrees, compress_rank=rank,
                                         key=key)
    jmats = [jfedcmoo.flatten_grads(per) for per in jtrees]
    noise = None
    if rank:
        # every client is sketched with the first client's draw
        noise = _t(np.asarray(jax.random.normal(
            jax.random.split(key, c)[0], (jmats[0].shape[1], rank),
            jnp.float32)))
        jmats = [jfedcmoo.sketch(mm, rank, jax.random.split(key, c)[0])
                 for mm in jmats]
    slack = 1 / min(1.0, _curvature(jmats))
    got = fedcmoo.fedcmoo_round_lambda(ttrees, compress_rank=rank,
                                       noise=noise)
    stacked = torch.stack([fedcmoo.flatten_grads(per) for per in ttrees])
    got_stacked = fedcmoo.fedcmoo_round_lambda_stacked(
        stacked, compress_rank=rank, noise=noise)
    want_stacked = jfedcmoo.fedcmoo_round_lambda_stacked(
        jnp.stack([jfedcmoo.flatten_grads(per) for per in jtrees]),
        compress_rank=rank, key=key)
    assert torch.equal(got, got_stacked)
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(want_stacked))
    assert got.shape == (M,) and abs(float(got.sum()) - 1) < 1e-6
    assert 0 < float(got[0]) < 1, got
    assert_close(got, want, 1e-5 * slack, "lambda")
    # server_solve alone, on the matrices the server averaged
    assert_close(fedcmoo.server_solve([_t(np.asarray(a)) for a in jmats]),
                 jfedcmoo.server_solve(jmats), 1e-5 * slack, "server_solve")


# ------------------------------------------------------ the local steps
def _with_lora_b(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                    if k == "lora_B" else _with_lora_b(v, rng))
                for k, v in tree.items()}
    return tree


def _setup(seed=0):
    """(JAX, port) config, frozen weights, one JAX batch and a client
    state with a non-zero critic, lam and step, as in
    ``test_torch_training.py``."""
    jcfg, tcfg = _cfgs()
    tree = jax.tree_util.tree_map(np.asarray, jT.init_params(
        jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    tree = _with_lora_b(tree, np.random.default_rng(seed))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = bridge.to_torch(tree, device="cpu")
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    rng = np.random.default_rng(seed + 5)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    mask = np.concatenate([np.zeros((B, P)), np.ones((B, MAX_NEW))],
                          1).astype(np.float32)
    mask[1, -2:] = 0.0
    lp = np.asarray(jppo.token_logprobs(
        jT.forward_seq(jcfg, jp, jnp.asarray(tokens))["logits"],
        jnp.asarray(tokens)), np.float32)
    old = (lp + rng.normal(0, 0.05, lp.shape) * mask).astype(np.float32)
    refl = (lp + rng.normal(0, 0.1, lp.shape) * mask).astype(np.float32)
    r = rng.uniform(0, 1, (B, M)).astype(np.float32)
    arrays = (tokens, mask, old, refl, r)
    jb = jppo.PPOBatch(*map(jnp.asarray, arrays))
    tb = ppo.PPOBatch(_t(tokens).long(), *map(_t, arrays[1:]))
    js = jlocal.init_client_state(jtrain, M, jcfg.d_model, kl_coef=0.1)
    js = js._replace(
        critic={"w": jnp.asarray(rng.normal(0, 0.3, (M, jcfg.d_model)),
                                 jnp.float32)},
        lam=jnp.asarray([0.3, 0.7], jnp.float32),
        step=jnp.asarray(2, jnp.int32))
    ts = bridge.client_state_to_torch(jax.tree_util.tree_map(np.asarray, js),
                                      device="cpu")
    return (jcfg, tcfg), (jfrozen, tfrozen), (jb, tb), (js, ts)


def _state_close(ts, js, lr):
    """Every field of the port's ClientState against the JAX one; the
    Adam steps (moves over lr) within 1e-2 of their scale, as in
    ``test_torch_training.py``."""
    assert_trees_close(ts.trainable, js.trainable, 1e-4, "adapters")
    assert_trees_close(ts.opt.mu, js.opt.mu, 1e-4, "adam mu")
    assert_trees_close(ts.opt.nu, js.opt.nu, 1e-4, "adam nu")
    assert int(ts.opt.count) == int(js.opt.count)
    assert_close(ts.critic["w"], js.critic["w"], 1e-4, "critic")
    assert_close(ts.kl_coef, js.kl_coef, 1e-4, "kl_coef")
    assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32


def _adam_steps_close(tnew, told, jnew, jold, lr):
    """The Adam steps (moves over lr) within 1e-2 of their scale, where
    Adam's denominator sqrt(v_hat) is at least 100 eps (1e-6).

    The step is m_hat / (sqrt(v_hat) + eps); its derivative in g is about
    eps / (|g| + eps)^2, so where |g| nears eps the step turns on the last
    bits of g.  A fixed combination of the objectives' gradients cancels
    there: under equal weights, leaves of the second batch hold entries
    where g_2 = -g_1 to 7e-5 of their size, so the clipped direction is
    ~7e-8 and a 5e-6 relative difference of g_1 and g_2 (held to 1e-4 by
    the gradient checks) moves the step by ~2e-2.  Those entries are held
    through the gradients; they must stay under 1% of the adapters.
    """
    count = float(np.asarray(jnew.opt.count))
    below, total = 0, 0
    for i, (a, b, c, d, v) in enumerate(zip(
            common.tree_leaves(tnew.trainable),
            common.tree_leaves(told.trainable),
            jax.tree_util.tree_leaves(jnew.trainable),
            jax.tree_util.tree_leaves(jold.trainable),
            jax.tree_util.tree_leaves(jnew.opt.nu))):
        well = np.sqrt(np.asarray(v) / (1 - 0.999 ** count)) >= 1e-6
        below += int((~well).sum())
        total += well.size
        assert_close(((a - b) / lr).numpy()[well],
                     ((np.asarray(c) - np.asarray(d)) / lr)[well],
                     1e-2, f"Adam step {i}")
    assert below <= 0.01 * total, (below, total)


def test_fedcmoo_local_grads_and_apply_match_jax():
    (jcfg, tcfg), (jfr, tfr), (jb, tb), (js, ts) = _setup(0)
    jfc, tfc = _fcs(n_objectives=M, batch_size=B)
    jg, jl, (jm, jfeats, jr, jmask) = jlocal.fedcmoo_local_grads(
        jcfg, jfc, js, jfr, jb)
    tg, tl, extras = local.fedcmoo_local_grads(tcfg, tfc, ts, tfr, tb)
    tm, tfeats, tr, tmask = extras
    assert len(tg) == len(jg) == M
    for j in range(M):
        assert_trees_close(tg[j], jg[j], 1e-4, f"grad {j}")
    assert_close(tl, jl, 1e-4, "losses")
    assert set(tm) == set(jm)
    for key in jm:
        assert_close(tm[key], jm[key], 1e-4, key)
    assert_close(tfeats, jfeats, 1e-4, "features")
    assert_close(tr, jr, 1e-4, "shaped rewards")
    np.testing.assert_array_equal(_np(tmask), np.asarray(jmask))
    # what waits across the server exchange holds no autograd graph
    assert not any(t.requires_grad for t in (tfeats, tr, tmask, tl))
    assert not any(t.requires_grad for g in tg
                   for t in common.tree_leaves(g))
    lam = np.asarray([0.35, 0.65], np.float32)
    jnew, jmet = jlocal.fedcmoo_local_apply(jfc, js, jg, jnp.asarray(lam),
                                            (jm, jfeats, jr, jmask))
    tnew, tmet = local.fedcmoo_local_apply(tfc, ts, tg, _t(lam), extras)
    assert set(tmet) == set(jmet)
    for key in jmet:
        assert_close(tmet[key], jmet[key], 1e-4, key)
    _state_close(tnew, jnew, tfc.actor_lr)
    # the server's lambda, stored unsmoothed
    np.testing.assert_array_equal(_np(tnew.lam), lam)
    _adam_steps_close(tnew, ts, jnew, js, tfc.actor_lr)


@pytest.mark.parametrize("weights", [(0.5, 0.5), (0.7, 0.3)])
def test_linear_local_step_matches_jax(weights):
    (jcfg, tcfg), (jfr, tfr), (jb, tb), (js, ts) = _setup(1)
    jfc, tfc = _fcs(n_objectives=M, batch_size=B)
    ec = EngineConfig(linear_weights=None if weights == (0.5, 0.5)
                      else weights)
    tw = alg.get_algorithm("linear").traced_extra(tfc, ec, device="cpu")
    jw = jalg.get_algorithm("linear").traced_extra(jfc, ec)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tw.dtype == torch.float32
    jnew, jm = jlocal.linear_local_step(jcfg, jfc, js, jfr, jb, jw)
    tnew, tm = local.linear_local_step(tcfg, tfc, ts, tfr, tb, tw)
    assert set(tm) == set(jm)
    for key in jm:
        assert_close(tm[key], jm[key], 1e-4, key)
    _state_close(tnew, jnew, tfc.actor_lr)
    np.testing.assert_array_equal(_np(tnew.lam), np.asarray(jw))
    _adam_steps_close(tnew, ts, jnew, js, tfc.actor_lr)
