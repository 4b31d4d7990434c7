"""Generation as a captured program: the decode step with a device
position, the runner that captures and replays it, and serve, on the CPU
at a tiny size.

On the card ``rlhf.sampling.decode`` captures one decode step as a CUDA
graph and replays it; here the same runner (``_decode``) is driven through
a stand-in graph (``_StandInGraph``) whose capture runs the step on a copy
of its buffers (a capture executes nothing) and whose replay runs it on the
buffers it captured, and the kernels' launch counters are moved by a
counting plain rmsnorm (on the CPU nothing launches).  ``chip_smoke.py``'s
``decode_graph`` phase holds the real graph to ``_decode_eager`` on the
card at full width.

Configs: llama-3.2-1b reduced to 2 layers, d_model 64, vocab 256, 2 KV
heads (``test_torch_models.py``'s), and zamba2-1.2b reduced to one period
of its 19 slots, d_model 64, vocab 64 (``test_torch_hybrid.py``'s), with
the JAX model's parameters (non-zero ``lora_B``) carried over by
``bridge``.  Tolerances: against the JAX package, f32 logits to 1e-4 of
their scale and bf16 to 2e-2 of it, ``|got - want| <= tol * max(1,
max|want|)``, but zamba2 in bf16, whose 19 blocks take both sides' bf16
logits ~3% of the scale apart (8.3e-2 at 2.6 here), which is held by
``test_torch_hybrid.py``'s f32 rule (``_f32_rule``); the generated tokens exactly and their logprobs as the
rollout tests hold them (1e-4 with llama's f32 weights, 2e-2 of the scale
on zamba2, whose bf16 K/V cache flips roundings; ``test_torch_hybrid.py``).
Within the port, bit for bit: the device-position step against the
Python-int step the port had before, and every runner against
``_decode_eager``.
"""
import ast
import dataclasses
import functools
import inspect
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
from repro_torch import bridge, rng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import counters, ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, common, moe, ssm, xlstm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.rlhf import sampling  # noqa: E402

B, P, STEPS = 2, 6, 5
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-4, "bf16": 2e-2}
MODELS = ("llama", "zamba2")


def _cfgs(model: str):
    if model == "llama":
        return tuple(dataclasses.replace(
            get("llama-3.2-1b").reduced(n_layers=2, d_model=64, vocab=256),
            n_kv_heads=2) for get in (jax_get_config, get_config))
    if model == "mixtral":
        # a window of 4, which the prompt of P tokens fills: a ring
        return tuple(dataclasses.replace(
            get("mixtral-8x7b").reduced(n_layers=2, d_model=64, vocab=64),
            sliding_window=4) for get in (jax_get_config, get_config))
    return tuple(get("zamba2-1.2b").reduced(n_layers=2, d_model=64, vocab=64)
                 for get in (jax_get_config, get_config))


@functools.lru_cache(maxsize=None)
def _params(model: str, dt: str):
    """(JAX tree, torch tree) holding the same values, non-zero lora_B."""
    jcfg, _ = _cfgs(model)
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(3),
                                   dtype=JDT[dt]))
    gen = np.random.default_rng(3)

    def lora_b(t):
        if isinstance(t, dict):
            return {k: (gen.normal(0, 0.05, v.shape).astype(np.float32)
                        if k == "lora_B" else lora_b(v))
                    for k, v in t.items()}
        return t

    tree = lora_b(tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        bridge.to_torch(tree, device="cpu")


def _tokens(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _of_scale(got, want, tol: float, what: str) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _f32_rule(got, want, want_f32, what: str) -> None:
    """The port's bf16 results as close to the f32 model's (the same bf16
    weights, upcast, an f32 cache) as the reference's bf16 results are,
    within 25% on the mean and the root-mean-square error, each tensor
    scaled by its max|want_f32| and all pooled (``test_torch_hybrid.py``'s
    rule)."""
    e_got, e_ref = [], []
    for g, w, w32 in zip(got, want, want_f32, strict=True):
        g, w, w32 = _np(g), _np(w), _np(w32)
        scale = max(float(np.abs(w32).max()), 1e-30)
        e_got.append(np.abs(g - w32).ravel() / scale)
        e_ref.append(np.abs(w - w32).ravel() / scale)
    e_got, e_ref = np.concatenate(e_got), np.concatenate(e_ref)
    for stat, f in (("mean", np.mean),
                    ("rms", lambda e: np.sqrt(np.mean(np.square(e))))):
        assert float(f(e_got)) <= 1.25 * float(f(e_ref)), (what, stat)


def _jax_decode_logits(jcfg, jp, tok, cdt):
    """The reference's logits of each decode step after prefill(P)."""
    size = tok.shape[1]
    _, jcache = jax.jit(lambda pr, t: jT.prefill(
        jcfg, pr, t, cache_len=size, cache_dtype=cdt))(
            jp, jnp.asarray(tok[:, :P]))
    jdec = jax.jit(lambda pr, c, t: jT.decode_step(jcfg, pr, c, t))
    out = []
    for t in range(P, size):
        jl, jcache = jdec(jp, jcache, jnp.asarray(tok[:, t:t + 1]))
        out.append(jl)
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


# ------------------------------------ the decode step the port had before
def _old_block_decode(kind, p, cfg, x, cache, pos: int):
    """``transformer.block_decode`` before the position moved to the
    device: a Python int, the slot written by a Python index."""
    if kind == "mamba2":
        return ssm.mamba2_decode(p, cfg, x, cache)[0]
    k_cache, v_cache = cache["k"], cache["v"]
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = common.rms_norm(p["ln1"], x, cfg.norm_eps)
    q = common.linear(p["attn"]["wq"], h).reshape(b, 1, hq, dh)
    k = common.linear(p["attn"]["wk"], h).reshape(b, 1, hkv, dh)
    v = common.linear(p["attn"]["wv"], h).reshape(b, 1, hkv, dh)
    posv = torch.full((1,), pos, device=x.device)
    q = common.apply_rope(q, posv, cfg.rope_theta)
    k = common.apply_rope(k, posv, cfg.rope_theta)
    idx = pos % k_cache.shape[1]
    k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
    c = k_cache.shape[1]
    qg = (q * dh ** -0.5).reshape(b, hkv, hq // hkv, dh)
    s = qg.float() @ k_cache.permute(0, 2, 3, 1).float()
    s = torch.where(torch.arange(c) <= pos, s, attention.NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = (pr.to(v_cache.dtype).float()
         @ v_cache.permute(0, 2, 1, 3).float()).reshape(b, 1, hq, dh)
    x = x + common.linear(p["attn"]["wo"], o.to(q.dtype).reshape(
        b, 1, hq * dh))
    h2 = common.rms_norm(p["ln2"], x, cfg.norm_eps)
    return x + common.swiglu(p["mlp"], h2)


@torch.no_grad()
def _old_decode_step(cfg, params, cache, token):
    x = params["embed"][token]
    pos = cache["pos"]
    for period in range(cfg.n_periods):
        for i, kind in enumerate(cfg.pattern):
            piece = {name: t[period]
                     for name, t in cache["slots"][str(i)].items()}
            x = _old_block_decode(kind, T._slot_params(cfg, params, i,
                                                       period),
                                  cfg, x, piece, pos)
    x = common.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = common.linear(params["lm_head"], x)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("model", MODELS)
def test_decode_step_with_a_device_position(model, dt):
    """prefill(P), then STEPS decode steps with weights and cache in
    ``dt``: the position a 0-d int32 tensor advanced in place; each step's
    logits against JAX's ``decode_step`` (f32 1e-4, bf16 2e-2 of the
    scale; zamba2 in bf16 the f32 rule) and bit for bit against the
    Python-int step the port had before, the cache too."""
    jcfg, tcfg = _cfgs(model)
    jp, tp = _params(model, dt)
    size = P + STEPS
    tok = _tokens(11, (B, size), tcfg.vocab)
    jlogits = _jax_decode_logits(jcfg, jp, tok, JDT[dt])
    _, cache = T.prefill(tcfg, tp, torch.from_numpy(tok[:, :P]).long(),
                         cache_len=size, cache_dtype=TDT[dt])
    old = _clone(cache)
    old["pos"] = P
    pos = cache["pos"]
    assert pos.dim() == 0 and pos.dtype == torch.int32 and pos == P
    logits = []
    for t in range(P, size):
        step_tok = torch.from_numpy(tok[:, t:t + 1]).long()
        got, cache = T.decode_step(tcfg, tp, cache, step_tok)
        want_old, old = _old_decode_step(tcfg, tp, old, step_tok)
        assert torch.equal(got, want_old), t
        assert cache["pos"] is pos and pos == t + 1 == old["pos"]
        logits.append(got)
    for i, piece in cache["slots"].items():
        for name, got in piece.items():
            assert torch.equal(got, old["slots"][i][name]), (i, name)
    if model == "zamba2" and dt == "bf16":
        jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        _f32_rule(logits, jlogits,
                  _jax_decode_logits(jcfg, jp32, tok, jnp.float32),
                  "decode logits")
        return
    for t, (got, want) in enumerate(zip(logits, jlogits)):
        _of_scale(got, want, TOL[dt], f"decode logits at step {t}")


# ----------------------------------------------------------------- runner
class _StandInGraph:
    """What a CUDA graph does, on the CPU: ``capture`` runs the step on a
    copy of the buffers, so that Python runs (and the counters move) but
    nothing the replays read changes; ``replay`` runs it on the buffers it
    captured, and, as a real replay runs no Python, leaves the launch
    counters where they were."""

    def __init__(self):
        self.warms = self.captures = self.replays = 0

    def warm(self, step, state):
        self.warms += 1
        step(state)

    def capture(self, step, state):
        self.captures += 1
        step(_clone(state))
        self._step, self._state = step, state

    def replay(self):
        self.replays += 1
        before = counters.read()
        self._step(self._state)
        counters.add(counters.since(before), -1)


@pytest.fixture
def counting_rmsnorm(monkeypatch):
    """The plain rmsnorm, counted as the kernel's wrapper counts."""
    def counted(x, g, eps=1e-5, *, use_kernel=True):
        rn_mod.launches += 1
        return ref.rmsnorm(x, g, eps)

    monkeypatch.setattr(ops, "rmsnorm", counted)
    counters.zero()
    yield
    counters.zero()


def _prefilled(model: str, max_new: int, seed: int):
    _, tcfg = _cfgs(model)
    _, tp = _params(model, "f32")
    prompt = torch.from_numpy(_tokens(seed, (B, P), tcfg.vocab)).long()
    _, cache = T.prefill(tcfg, tp, prompt, cache_len=P + max_new)
    return tcfg, tp, prompt, cache


def _noise(source: str, tcfg, max_new: int):
    if source == "generator":
        return dict(generator=torch.Generator().manual_seed(5))
    g = np.random.default_rng(5).gumbel(size=(max_new, B, tcfg.vocab))
    return dict(gumbel=torch.from_numpy(g.astype(np.float32)))


def _per_forward(cfg) -> int:
    """rmsnorm calls of one decode step: two a block, one a Mamba2 block,
    and the final norm."""
    n_mamba = cfg.pattern.count("mamba2") * cfg.n_periods
    return 2 * (cfg.n_layers - n_mamba) + n_mamba + 1


@pytest.mark.parametrize("runner", ["stand-in graph", "eager step"])
@pytest.mark.parametrize("source", ["generator", "gumbel"])
@pytest.mark.parametrize("model", MODELS)
def test_runner_matches_the_eager_loop(model, source, runner,
                                       counting_rmsnorm):
    """The runner, through the stand-in graph or stepping eagerly, gives
    ``_decode_eager``'s tokens and logprobs bit for bit and leaves the
    cache as it does; the launch counters come out equal and exact: the
    capture's increment taken back, a replay's added each replay."""
    max_new = 7
    tcfg, tp, prompt, cache = _prefilled(model, max_new, seed=21)
    counters.zero()
    ref_cache = _clone(cache)
    want = sampling._decode_eager(tcfg, tp, ref_cache, prompt[:, -1:],
                                  max_new=max_new, temperature=0.7,
                                  **_noise(source, tcfg, max_new))
    want_counts = counters.read()
    assert want_counts["rmsnorm"] == _per_forward(tcfg) * max_new
    counters.zero()
    graph = _StandInGraph() if runner == "stand-in graph" else None
    got = sampling._decode(tcfg, tp, cache, prompt[:, -1:], max_new=max_new,
                           temperature=0.7, graph=graph,
                           **_noise(source, tcfg, max_new))
    assert counters.read() == want_counts
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.long and got[1].dtype == torch.float32
    assert cache["pos"] == P + max_new
    for i, piece in cache["slots"].items():
        for name, t in piece.items():
            assert torch.equal(t, ref_cache["slots"][i][name]), (i, name)
    if graph is not None:
        assert (graph.warms, graph.captures, graph.replays) == \
            (1, 1, max_new - 1)


def test_one_new_token_captures_nothing(counting_rmsnorm):
    tcfg, tp, prompt, cache = _prefilled("llama", 1, seed=22)
    counters.zero()
    graph = _StandInGraph()
    got = sampling._decode(tcfg, tp, cache, prompt[:, -1:], max_new=1,
                           temperature=1.0, gumbel=None,
                           generator=torch.Generator().manual_seed(1),
                           graph=graph)
    assert got[0].shape == (B, 1)
    assert (graph.warms, graph.captures, graph.replays) == (1, 0, 0)
    assert counters.read()["rmsnorm"] == _per_forward(tcfg)


def test_decode_needs_one_noise_source():
    tcfg, tp, prompt, cache = _prefilled("llama", 2, seed=23)
    with pytest.raises(ValueError, match="exactly one"):
        sampling.decode(tcfg, tp, cache, prompt[:, -1:], max_new=2)


@pytest.mark.parametrize("model", MODELS)
def test_generate_with_injected_gumbel_matches_jax(model):
    """``generate`` (the runner stepping eagerly on the CPU) and the runner
    through the stand-in graph against JAX's ``generate`` given JAX's own
    Gumbel draws: tokens and mask exact, logprobs to the rollout tests'
    tolerance; the two port paths bit for bit."""
    jcfg, tcfg = _cfgs(model)
    jp, tp = _params(model, "f32")
    max_new = 6
    prompt = _tokens(24, (B, P), tcfg.vocab)
    key = jax.random.PRNGKey(9)
    jtok, jlp, jmask = jgenerate(jcfg, jp, jnp.asarray(prompt), key,
                                 max_new=max_new)
    noise = torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(k, (B, tcfg.vocab)))
        for k in jax.random.split(key, max_new)]))
    tprompt = torch.from_numpy(prompt).long()
    ttok, tlp, tmask = sampling.generate(tcfg, tp, tprompt, max_new=max_new,
                                         gumbel=noise)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    if model == "llama":
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-4,
                                   atol=1e-4)
    else:
        _of_scale(tlp, jlp, 2e-2, "sampling logprobs")
    _, cache = T.prefill(tcfg, tp, tprompt, cache_len=P + max_new)
    gtok, glp = sampling._decode(tcfg, tp, cache, tprompt[:, -1:],
                                 max_new=max_new, temperature=1.0,
                                 generator=None, gumbel=noise,
                                 graph=_StandInGraph())
    assert torch.equal(gtok, ttok[:, P:]) and torch.equal(glp, tlp[:, P:])


# ------------------------------------------------------- no host sync
def _step_functions():
    """The Python the captured step runs: the step, the model's decode
    path, the sampling and the rmsnorm kernel's dispatch and wrapper."""
    return [sampling._step, rng.gumbel_from_uniform, rng.categorical,
            T.decode_step, T.block_decode, T._slot_params, T._layer,
            T._window, T._ffn, T._ring_positions,
            moe.moe_ffn, moe.capacity, moe._round_up, moe._one_hot,
            attention.decode_attention, ssm.mamba2_decode,
            xlstm.mlstm_decode, xlstm._mlstm_qkvg, xlstm._mlstm_step,
            xlstm.slstm_decode, xlstm._slstm_in, xlstm._slstm_step,
            xlstm._recur,
            ssm._split_proj, ssm.dims, common.linear, common.rms_norm,
            common.swiglu, common.apply_rope, common.rope_freqs,
            common.tree_map, ops.rmsnorm, ops._kernel, rn_mod.rmsnorm,
            rn_mod.RMSNorm.forward, rn_mod.rmsnorm_fwd, rn_mod._check]


HOST_READS = {"item", "tolist", "cpu", "numpy", "synchronize", "nonzero"}
PY_SCALARS = {"eps"}      # Python floats the wrapper passes to C as such


def test_the_captured_step_has_no_host_sync_in_its_source():
    """No ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.nonzero()`` or ``synchronize`` in any function the step runs, and
    no ``int(``/``float(``/``bool(`` but of a Python scalar."""
    found = []
    for fn in _step_functions():
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in HOST_READS:
                found.append((fn.__qualname__, f.attr))
            if isinstance(f, ast.Name) and f.id in ("int", "float", "bool"):
                arg = node.args[0] if node.args else None
                if not (isinstance(arg, ast.Constant) or (
                        isinstance(arg, ast.Name) and arg.id in PY_SCALARS)):
                    found.append((fn.__qualname__, f.id))
    assert not found, found


@pytest.mark.parametrize("model", MODELS + ("mixtral",))
def test_the_captured_step_reads_no_tensor_on_the_host(model, monkeypatch):
    """Run one step with every way of reading a tensor into Python (a
    truth value, ``int``, ``float``, an index, ``item``, ``tolist``)
    raising: a Python ``if`` on a tensor fails here too."""
    tcfg, tp, prompt, cache = _prefilled(model, 2, seed=25)
    state = sampling._new_state(tcfg, cache, prompt[:, -1:], 2)
    rng.uniform_noise((B, tcfg.vocab), generator=torch.Generator(),
                      device="cpu", out=state["noise"])

    def host_read(*args, **kw):
        raise AssertionError("the decode step read a tensor on the host")

    for name in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    with torch.no_grad():
        sampling._step(tcfg, tp, state, temperature=1.0, from_uniform=True)
    monkeypatch.undo()
    assert cache["pos"] == P + 1 and int(state["tokens"][:, 1].abs().sum()) == 0


def test_a_failed_capture_raises():
    """The runner's only ``try`` re-raises: nothing falls back to the eager
    loop."""
    tree = ast.parse(inspect.getsource(sampling))
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            assert isinstance(node.body[-1], ast.Raise)
            assert node.body[-1].exc is None


# ------------------------------------------------------------------ noise
def test_uniform_draw_into_a_buffer_gives_the_eager_noise():
    want = rng.gumbel_noise((3, 40), generator=torch.Generator().manual_seed(8),
                            device="cpu")
    buf = torch.empty((3, 40))
    got = rng.uniform_noise((3, 40), generator=torch.Generator().manual_seed(8),
                            device="cpu", out=buf)
    assert got is buf
    assert torch.equal(rng.gumbel_from_uniform(buf), want)
    with pytest.raises(ValueError, match="float32 of shape"):
        rng.uniform_noise((3, 41), generator=torch.Generator(), device="cpu",
                          out=buf)


def test_counters_cover_every_kernel_counter():
    """Every ``*launches`` integer of a kernel wrapper is in the table, and
    ``since``/``add`` move them as the runner needs."""
    mods = {mod for mod, _ in counters.COUNTERS.values()}
    listed = {(mod.__name__, attr) for mod, attr in counters.COUNTERS.values()}
    for mod in mods:
        for attr, value in vars(mod).items():
            if attr.endswith("launches") and isinstance(value, int):
                assert (mod.__name__, attr) in listed, (mod.__name__, attr)
    counters.zero()
    before = counters.read()
    rn_mod.launches += 3
    moved = counters.since(before)
    assert moved == {"rmsnorm": 3}
    counters.add(moved, -1)
    assert counters.read() == before
    counters.add(moved)
    counters.add(moved)
    assert counters.read()["rmsnorm"] == 6
    counters.zero()


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("arch", ["llama-3.2-1b", "zamba2-1.2b"])
def test_serve_returns_the_tokens_of_generate(arch, capsys):
    """``serve --device cpu`` decodes through the runner: its tokens are
    ``generate``'s for the same seed (the weights, then the prompts, then
    the noise from one generator)."""
    b, p, new, seed = 2, 5, 4, 3
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", str(b),
                      "--prompt-len", str(p), "--max-new", str(new),
                      "--seed", str(seed)])
    assert "decode:" in capsys.readouterr().out
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (b, p), generator=gen)
    tokens, _, _ = sampling.generate(cfg, params, prompt, max_new=new,
                                     temperature=0.8, generator=gen)
    assert torch.equal(out, tokens[:, p:])
