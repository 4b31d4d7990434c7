"""The port's ``cross`` and ``enc_attn`` block kinds, whisper-large-v3 and
llama-3.2-vision-90b, against the JAX package, on the CPU at a tiny size;
and the port's config registry against the reference's.

The configs are ``reduced``: whisper to 2 decoder (``cross``) layers and 2
encoder layers, vision to one period of its pattern (4 ``attn`` and 1
``cross``) with 16 vision tokens; d_model 64, 4 heads of 16, vocab 64.
Both sides get the same numpy inputs, the same modality stub (``aux``:
whisper's frames (B, 12, d), the VLM's vision tokens (B, 16, d)) and the
same parameters: the JAX model's ``init_params`` with non-zero ``lora_B``
(the adapters of the self- and cross-attention projections), carried
over by ``repro_torch.bridge``.  On the CPU the port's attention is the
flash kernel's plain version, non-causal in the encoder and at Sq != Skv
in the cross-attention.

Tolerances, as in ``test_torch_models.py``: f32 1e-4; bf16 2e-2 of the
compared tensor's scale, ``|got - want| <= 2e-2 * max(1, max|want|)``.
Generation with JAX's own Gumbel noise: the same tokens; the sampling
logprobs within 2e-2 of their scale, as ``test_torch_decode_graph.py``
holds zamba2's: generate's bf16 K/V cache rounds where a last-bit
difference of the f32 inputs can flip a rounding.  The local step in
f32 within 1e-4 of each value's scale (the gradients through Adam's
first moment), Adam's steps within 1e-2 of theirs
(``test_torch_training.py``'s) where |g| >= 100 eps.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.rlhf import local as jlocal  # noqa: E402
from repro.rlhf import ppo as jppo  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import bridge, trees  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.fed import algorithms, api  # noqa: E402
from repro_torch.fed.engine import FederatedTrainer  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.models import common, transformer as T  # noqa: E402
from repro_torch.rlhf import local, ppo, sampling, update_graph  # noqa: E402

ARCHS = {"whisper": "whisper-large-v3", "vision": "llama-3.2-vision-90b"}
B, S, TE = 2, 12, 12
P, MAX_NEW, M = 6, 6, 2
SR = P + MAX_NEW
TOL, STEP_TOL = 1e-4, 1e-2
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _cfgs(model: str):
    kw = dict(n_layers=5 if model == "vision" else 2, d_model=64, vocab=64)
    return (jconfigs.get_config(ARCHS[model]).reduced(**kw),
            get_config(ARCHS[model]).reduced(**kw))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, dt: str, what: str = "") -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if dt == "f32":
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=what)
    else:
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2 * scale,
                                   err_msg=what)


def assert_close(got, want, tol, what=""):
    """|got - want| <= tol * max(1, max|want|), element for element."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    limit = tol * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def _with_lora_b(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                    if k == "lora_B" else _with_lora_b(v, rng))
                for k, v in tree.items()}
    return tree


def _params(model: str, dt="f32", seed=0):
    """(JAX tree, port tree) holding the same values."""
    jcfg, _ = _cfgs(model)
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(seed),
                                   dtype=JDT[dt]))
    tree = _with_lora_b(tree, np.random.default_rng(seed))
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        bridge.to_torch(tree, device="cpu")


def _aux(model: str, dt="f32", seed=0, batch=B):
    """(JAX aux, port aux): the modality stub, drawn from the seed."""
    jcfg, _ = _cfgs(model)
    n = jcfg.n_vision_tokens if model == "vision" else TE
    x = np.random.default_rng(seed).standard_normal(
        (batch, n, jcfg.d_model)).astype(np.float32)
    name = "vision" if model == "vision" else "frames"
    return ({name: jnp.asarray(x).astype(JDT[dt])},
            {name: torch.from_numpy(x).to(TDT[dt])})


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def _gumbel(key, n: int, shape) -> np.ndarray:
    return np.stack([np.asarray(jax.random.gumbel(k, shape))
                     for k in jax.random.split(key, n)])


# ------------------------------------------------------------ the registry
def test_registry_configs_and_input_shapes_match_reference():
    """Every architecture of the reference, field for field; the input
    shapes, ``list_archs``, ``ASSIGNED_ARCHS`` and ``get_shape``."""
    assert configs.list_archs() == jconfigs.list_archs()
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    for arch in jconfigs.list_archs():
        j, t = jconfigs.get_config(arch), configs.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert t.param_count() == j.param_count(), arch
        assert t.param_count(active_only=True) == \
            j.param_count(active_only=True), arch
    assert {k: dataclasses.asdict(v) for k, v in
            configs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    for name in jconfigs.INPUT_SHAPES:
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(jconfigs.get_shape(name))
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("model", list(ARCHS))
def test_tree_matches_reference_layout(model):
    """The port's own initialiser builds the reference's tree (the
    encoder, ``lnx`` and the cross-attention adapters included); at full
    width (the meta device) whisper holds 2,036,149,760 parameters and
    one period of the VLM (5 of its 100 layers) 6,535,544,832."""
    jcfg, tcfg = _cfgs(model)
    jtree = jT.init_params(jcfg, jax.random.PRNGKey(0))
    ttree = T.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    jflat = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
             for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = {jax.tree_util.keystr(p): (tuple(x.shape),
                                      str(x.dtype).replace("torch.", ""))
             for p, x in jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert tflat == jflat
    # the bridge carries the tree (the encoder's subtree included) both
    # ways, shapes and dtypes kept
    back = bridge.to_torch(bridge.to_numpy(ttree), device="cpu")
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(
        trees.tree_leaves(back), trees.tree_leaves(ttree)))
    full = get_config(ARCHS[model])
    if model == "vision":
        full = dataclasses.replace(full, n_layers=5, n_periods=1)
    meta = T.init_params(full, generator=torch.Generator(), device="meta")
    assert trees.tree_size(meta) == {"whisper": 2_036_149_760,
                                     "vision": 6_535_544_832}[model]


# ------------------------------------------------------------- the blocks
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_enc_attn_and_cross_blocks_match_reference(dt):
    """One ``enc_attn`` block (non-causal self-attention over the frames)
    and one ``cross`` block (causal self-attention, then cross-attention
    at Sq = 12 against Skv = 16, no RoPE), with the pieces prefill keeps,
    against the reference's ``block_seq``."""
    jcfg, tcfg = _cfgs("whisper")
    jp, tp = _params("whisper", dt, seed=1)
    xs = np.random.default_rng(2).standard_normal(
        (B, 16, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(xs).astype(JDT[dt]), _t(xs).to(TDT[dt])
    jenc = jax.tree_util.tree_map(lambda a: a[0], jp["encoder"]["slots"]["0"])
    tenc = common.tree_map(lambda t: t[0], tp["encoder"]["slots"]["0"])
    want = jax.jit(lambda p, v: jT.block_seq(
        "enc_attn", p, jcfg, v, jnp.arange(16), None, False)[0])(jenc, jx)
    got = T.block_seq("enc_attn", tenc, tcfg, tx, torch.arange(16))[0]
    _close(got, want, dt, "enc_attn")
    # the encoder is bidirectional: the first frame sees the last one
    moved = tx.clone()
    moved[:, -1] += 1.0
    assert not torch.equal(T.block_seq("enc_attn", tenc, tcfg, moved,
                                       torch.arange(16))[0][:, 0], got[:, 0])
    hs = np.random.default_rng(3).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jh, th = jnp.asarray(hs).astype(JDT[dt]), _t(hs).to(TDT[dt])
    jdec = jax.tree_util.tree_map(lambda a: a[0], jp["slots"]["0"])
    tdec = common.tree_map(lambda t: t[0], tp["slots"]["0"])
    want, _, jpiece = jax.jit(lambda p, v, c: jT.block_seq(
        "cross", p, jcfg, v, jnp.arange(S), c, True))(jdec, jh, jx)
    got, aux, piece = T.block_seq("cross", tdec, tcfg, th, torch.arange(S),
                                  True, cross_states=tx)
    assert aux is None and sorted(piece) == sorted(jpiece)
    _close(got, want, dt, "cross")
    for name in piece:
        _close(piece[name], jpiece[name], dt, f"cross {name}")


# -------------------------------------------------------------- the models
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("model", list(ARCHS))
def test_forward_prefill_and_decode_with_aux_match_reference(model, dt):
    jcfg, tcfg = _cfgs(model)
    jp, tp = _params(model, dt, seed=4)
    jaux, taux = _aux(model, dt, seed=5)
    tok = _tokens(6, (B, S))
    want = jax.jit(lambda p, t, a: jT.forward_seq(jcfg, p, t, a))(
        jp, jnp.asarray(tok), jaux)
    got = T.forward_seq(tcfg, tp, torch.from_numpy(tok).long(), taux)
    _close(got["logits"], want["logits"], dt, "logits")
    _close(got["hidden"], want["hidden"], dt, "hidden")
    s0 = S - 3
    # the K/V cache in the model's dtype (f32 or bf16) on both sides
    jl, jcache = jax.jit(lambda p, t, a: jT.prefill(
        jcfg, p, t, a, cache_len=S, cache_dtype=JDT[dt]))(
            jp, jnp.asarray(tok[:, :s0]), jaux)
    tl, tcache = T.prefill(tcfg, tp, torch.from_numpy(tok[:, :s0]).long(),
                           taux, cache_len=S, cache_dtype=TDT[dt])
    _close(tl, jl, dt, "prefill logits")
    for i, piece in tcache["slots"].items():
        for name, t in piece.items():
            _close(t, jcache["slots"][i][name], dt, f"cache {i} {name}")
    cross = [i for i, k in enumerate(tcfg.pattern) if k == "cross"]
    n_cross = TE if model == "whisper" else tcfg.n_vision_tokens
    assert cross and all(tcache["slots"][str(i)]["ck"].shape[2] == n_cross
                         for i in cross)
    jstep = jax.jit(lambda p, c, t: jT.decode_step(jcfg, p, c, t))
    for t in range(s0, S):
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok[:, t:t + 1]))
        tlog, tcache = T.decode_step(tcfg, tp, tcache,
                                     torch.from_numpy(tok[:, t:t + 1]).long())
        _close(tlog, jlog, dt, f"decode {t}")
        if dt == "f32":
            # teacher-forced: the decode step is the forward's position t
            _close(tlog, got["logits"][:, t], dt, f"decode {t} vs forward")


@pytest.mark.parametrize("model", list(ARCHS))
def test_generate_with_aux_matches_reference(model):
    """``generate`` with the stub and JAX's own Gumbel noise: the same
    tokens and mask, the logprobs within the bf16 cache's tolerance."""
    jcfg, tcfg = _cfgs(model)
    jp, tp = _params(model, "f32", seed=7)
    jaux, taux = _aux(model, "f32", seed=8)
    prompt = _tokens(9, (B, P))
    key = jax.random.PRNGKey(10)
    jtok, jlp, jmask = jgenerate(jcfg, jp, jnp.asarray(prompt), key,
                                 max_new=MAX_NEW, aux=jaux)
    noise = _t(_gumbel(key, MAX_NEW, (B, jcfg.vocab)))
    ttok, tlp, tmask = sampling.generate(
        tcfg, tp, _t(prompt).long(), max_new=MAX_NEW, gumbel=noise, aux=taux)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # generate's bf16 K/V cache rounds keys, values and probabilities
    # where a last-bit difference of the f32 inputs can flip a rounding
    scale = float(np.abs(np.asarray(jlp)).max())
    assert float(np.abs(tlp.numpy() - np.asarray(jlp)).max()) <= 2e-2 * scale
    # and without the stub the forward raises as the reference's does
    with pytest.raises(KeyError):
        T.forward_seq(tcfg, tp, _t(prompt).long())


def _batch(jcfg, jp, jaux, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, SR)).astype(np.int32)
    mask = np.concatenate([np.zeros((B, P)), np.ones((B, MAX_NEW))],
                          1).astype(np.float32)
    mask[1, -2:] = 0.0
    lp = np.asarray(jppo.token_logprobs(
        jT.forward_seq(jcfg, jp, jnp.asarray(tokens), jaux)["logits"],
        jnp.asarray(tokens)), np.float32)
    old = (lp + rng.normal(0, 0.05, lp.shape) * mask).astype(np.float32)
    refl = (lp + rng.normal(0, 0.1, lp.shape) * mask).astype(np.float32)
    r = rng.uniform(0, 1, (B, M)).astype(np.float32)
    arrays = (tokens, mask, old, refl, r)
    return (jppo.PPOBatch(*map(jnp.asarray, arrays)),
            ppo.PPOBatch(_t(tokens).long(), *map(_t, arrays[1:])))


def _client(model, seed):
    """The same model, batch and client state on both sides (f32)."""
    jcfg, tcfg = _cfgs(model)
    jp, tp = _params(model, "f32", seed=seed)
    jaux, taux = _aux(model, "f32", seed=seed + 1)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    _, tfrozen = common.split_trainable(tp)
    jb, tb = _batch(jcfg, jp, jaux, seed=seed + 2)
    js = jlocal.init_client_state(jtrain, M, jcfg.d_model, kl_coef=0.1)
    js = js._replace(lam=jnp.asarray([0.3, 0.7], jnp.float32),
                     step=jnp.asarray(2, jnp.int32))
    ts = bridge.client_state_to_torch(jax.tree_util.tree_map(np.asarray, js),
                                      device="cpu")
    return (jcfg, jfrozen, jb, js, jaux), (tcfg, tfrozen, tb, ts, taux)


@pytest.mark.parametrize("model", list(ARCHS))
def test_firm_local_step_with_aux_matches_reference(model):
    """One local FIRM step on the adapters (self- and cross-attention's),
    the stub read by the forward; whisper's encoder is differentiated
    through (its adapters are trainable too)."""
    (jcfg, jfrozen, jb, js, jaux), (tcfg, tfrozen, tb, ts, taux) = \
        _client(model, 11)
    jfc = dataclasses.replace(JFIRMConfig(), n_objectives=M, batch_size=B)
    tfc = dataclasses.replace(FIRMConfig(), n_objectives=M, batch_size=B)
    jnew, jm = jlocal.firm_local_step(jcfg, jfc, js, jfrozen, jb, jaux)
    tnew, tm = local.firm_local_step(tcfg, tfc, ts, tfrozen, tb, taux)
    assert set(tm) == set(jm)
    for key in jm:
        assert_close(tm[key], jm[key], TOL, key)
    # the gradients through Adam's first moment (mu = (1 - b1) g on a
    # fresh state), then the steps where |g| >= 100 eps: below that
    # g / (|g| + eps) turns on g's last bits, and a few elements of a
    # cancelling sum sit there
    for i, (g, w) in enumerate(zip(common.tree_leaves(tnew.opt.mu),
                                   jax.tree_util.tree_leaves(jnew.opt.mu))):
        assert_close(g, w, TOL, f"adam mu {i}")
    lr = tfc.actor_lr
    for i, (tn, to, jn, jo, mu) in enumerate(zip(
            common.tree_leaves(tnew.trainable),
            common.tree_leaves(ts.trainable),
            jax.tree_util.tree_leaves(jnew.trainable),
            jax.tree_util.tree_leaves(js.trainable),
            jax.tree_util.tree_leaves(jnew.opt.mu))):
        big = np.abs(_np(mu)) >= 0.1 * 1e-6
        assert big.mean() > 0.9
        assert_close(((tn - to) / lr)[torch.from_numpy(big)],
                     ((_np(jn) - _np(jo)) / lr)[big], STEP_TOL,
                     f"Adam step {i}")
    if model == "whisper":
        enc = common.split_trainable(tnew.trainable)[0]["encoder"]
        assert trees.tree_leaves(enc)


class _StandInGraph:
    """A CPU stand-in for ``update_graph.UpdateGraph``: ``capture`` runs
    the step and hands back sentinel outputs; ``replay`` runs it again into
    them, the launch counters left as a real replay leaves them."""

    def __init__(self, device):
        self.captures = self.replays = 0

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        self.captures += 1
        outs, names = fn()
        self._fn = fn
        self._outs = [torch.full_like(t, 7) for t in outs]
        return self._outs, names

    def replay(self):
        self.replays += 1
        before = counters.read()
        outs, _ = self._fn()
        counters.add(counters.since(before), -1)
        update_graph._copy(self._outs, outs)


def test_update_graph_takes_aux_as_an_operand():
    """The stub rides the captured update as a static operand: the graph's
    A, B, A steps (warm, capture and replay, replay) bit for bit the eager
    steps on each stub, one capture for one key, a stub of another shape
    another key."""
    _, (tcfg, tfrozen, tb, ts, taux) = _client("vision", 13)
    tfc = dataclasses.replace(FIRMConfig(), n_objectives=M, batch_size=B)
    alg = algorithms.get_algorithm("firm")
    graphs = update_graph.UpdateGraphs(_StandInGraph)
    other = {"vision": taux["vision"] + 0.5}
    flat = lambda out: update_graph._state_leaves(out[0]) + [  # noqa: E731
        out[1][k] for k in sorted(out[1])]
    for aux in (taux, other, taux):
        got = alg.step(tcfg, tfc, ts, tfrozen, tb, None, None, graphs,
                       aux=aux)
        want = alg.step(tcfg, tfc, ts, tfrozen, tb, None, None, None,
                        aux=aux)
        assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
    assert graphs.captures == 1
    wider = {"vision": torch.cat([taux["vision"]] * 2, dim=1)}
    alg.step(tcfg, tfc, ts, tfrozen, tb, None, None, graphs, aux=wider)
    assert graphs.uncaptured() == 1


# ------------------------------------------------------ trainer and serve
@pytest.mark.parametrize("arch", configs.list_archs())
def test_stub_key_is_the_key_the_reference_reads(arch):
    """``transformer.stub_key`` names the aux entry the reference's
    ``_cross_source`` reads for each arch (its ``KeyError`` on an empty
    aux), None where it reads none; the trainer's refusal and the serving
    stub follow it."""
    from repro_torch.launch import serve
    jcfg, tcfg = jconfigs.get_config(arch), get_config(arch)
    try:
        jT._cross_source(jcfg, None, {})
        want = None
    except KeyError as e:
        want = e.args[0]
    assert T.stub_key(tcfg) == want
    stub = serve.modality_stub(tcfg, 1, 4, "meta")
    assert (stub is None) if want is None else list(stub) == [want]


@pytest.mark.parametrize("model", list(ARCHS))
def test_init_cache_needs_the_cross_length(model):
    """A config with cross blocks gets its cross K/V length from the
    caller (prefill passes the source's); without it ``init_cache``
    raises rather than build a cross K/V of a made-up length."""
    _, tcfg = _cfgs(model)
    with pytest.raises(ValueError, match="n_cross"):
        T.init_cache(tcfg, B, SR, device="cpu")
    cache = T.init_cache(tcfg, B, SR, device="cpu", n_cross=7)
    crosses = [piece["ck"].shape[2] for piece in cache["slots"].values()
               if "ck" in piece]
    assert crosses and set(crosses) == {7}


@pytest.mark.parametrize("model", list(ARCHS))
def test_federated_trainer_refuses_a_config_without_its_stub(model):
    """The round passes no stub (the reference's fails at its first
    rollout with KeyError), so the trainer refuses the config at
    construction, naming the stub."""
    _, tcfg = _cfgs(model)
    stub = "vision" if model == "vision" else "frames"
    with pytest.raises(ValueError, match=f"aux\\['{stub}'\\]"):
        FederatedTrainer(tcfg, FIRMConfig(n_clients=2), device="cpu")


@pytest.mark.parametrize("model", list(ARCHS))
def test_serve_cli_runs_with_the_reference_stub(model, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", ARCHS[model], "--device", "cpu", "--batch",
                      "2", "--prompt-len", "5", "--max-new", "3"])
    assert tuple(out.shape) == (2, 3)
    assert f"{ARCHS[model]}-smoke" in capsys.readouterr().out
    stub = serve.modality_stub(_cfgs(model)[1], 2, 5, "cpu")
    name = "vision" if model == "vision" else "frames"
    n = 16 if model == "vision" else 10
    assert list(stub) == [name] and stub[name].shape == (2, n, 64) \
        and stub[name].dtype == torch.bfloat16 and not stub[name].any()
