"""The port's zamba2 hybrid (Mamba2 blocks and one shared attention block)
against the JAX package, on the CPU at a tiny size.

The config is ``get_config("zamba2-1.2b").reduced(n_layers=2, d_model=64,
vocab=64)``: one period of the 19-slot pattern (16 Mamba2 slots, 3 shared
attention slots), 4 heads of 16, din 128, 2 SSM heads of 64, ds 16.  Both
sides get the same numpy inputs and the same parameters: the JAX model's
``init_params`` (with non-zero ``lora_B`` on the shared block's adapters,
its only ones) carried over by ``repro_torch.bridge``.  The JAX side is
jitted.

Tolerances: f32 1e-4 (``rtol`` and ``atol``); bf16 2e-2 of the compared
tensor's scale, ``|got - want| <= 2e-2 * max(1, max|want|)``, as in
``test_torch_models.py``, for one Mamba2 block.  Through the whole
19-block model bf16 rounding differences grow to ~3% of the scale on
both sides alike, so there bf16 is held by the f32 rule (``_f32_rule``):
the port's bf16 result as close to the f32 model's as the reference's
bf16 result is.  Decoding with the default bf16 K/V cache
(``generate``'s, on both sides) rounds keys, values and the attention
probabilities to bf16, where a last-bit difference of the f32 inputs can
flip a rounding; the sampling logprobs are therefore held to the bf16
tolerance, while the same decode with an f32 cache is held to 1e-4.  The
SSD plain versions against the exact recurrence: 1e-4 of the scale (the
chunked form sums in another order).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.rlhf import ppo as jppo, rewards as jrewards  # noqa: E402
from repro.rlhf.sampling import generate as jgenerate  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.fed.engine import (EngineConfig, FederatedTrainer,  # noqa
                                    rollout_batch)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.models import common, ssm, transformer as T  # noqa: E402
from repro_torch.rlhf import rewards  # noqa: E402
from repro_torch.rlhf.sampling import generate  # noqa: E402

ARCH = "zamba2-1.2b"
B, S = 2, 20
F32 = dict(rtol=1e-4, atol=1e-4)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _cfgs():
    return (jax_get_config(ARCH).reduced(n_layers=2, d_model=64, vocab=64),
            get_config(ARCH).reduced(n_layers=2, d_model=64, vocab=64))


def _with_lora_b(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                    if k == "lora_B" else _with_lora_b(v, rng))
                for k, v in tree.items()}
    return tree


def _params(dt: str, seed: int = 0):
    """(JAX tree, torch tree) holding the same values."""
    jcfg, _ = _cfgs()
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(seed),
                                   dtype=JDT[dt]))
    tree = _with_lora_b(tree, np.random.default_rng(seed))
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        bridge.to_torch(tree, device="cpu")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, dt: str, what: str = "") -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dt == "f32":
        np.testing.assert_allclose(got, want, err_msg=what, **F32)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale,
                                   err_msg=what)


def _of_scale(got, want, tol: float, what: str = "") -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _tokens(seed, shape, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ----------------------------------------------------------------- configs
def test_config_reduced_and_param_count_match_reference():
    jfull, tfull = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(jfull) == dataclasses.asdict(tfull)
    jcfg, tcfg = _cfgs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.n_layers == 19 and tcfg.pattern.count("mamba2") == 16
    assert ssm.dims(tcfg) == jssm.dims(jcfg) == (128, 2, 64, 16)
    for j, t in ((jfull, tfull), (jcfg, tcfg)):
        assert t.param_count() == j.param_count()
    # the reference counts the shared block once per pattern slot
    assert tfull.param_count() == 1_150_912_512
    # a Mamba2 + mLSTM hybrid is counted as the reference counts it, and
    # built and run as the reference runs it (f32)
    jmlstm, mlstm = (dataclasses.replace(c, pattern=("mamba2", "mlstm"),
                                         n_layers=2) for c in (jcfg, tcfg))
    assert mlstm.param_count() == jmlstm.param_count()
    T.init_params(mlstm, generator=torch.Generator(), device="cpu")
    jtree = jax.tree_util.tree_map(np.asarray, jT.init_params(
        jmlstm, jax.random.PRNGKey(2), dtype=jnp.float32))
    tok = _tokens(15, (B, S))
    want = jT.forward_seq(jmlstm, jax.tree_util.tree_map(jnp.asarray, jtree),
                          jnp.asarray(tok))["logits"]
    got = T.forward_seq(mlstm, bridge.to_torch(jtree, device="cpu"),
                        torch.from_numpy(tok).long())["logits"]
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_init_params_layout_matches_reference():
    """Same keys, shapes and dtypes as the reference's tree (values differ:
    the generators differ); one unstacked shared block; adapters only on
    the shared block's attention."""
    jcfg, tcfg = _cfgs()
    jtree = jT.init_params(jcfg, jax.random.PRNGKey(0))
    ttree = T.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    jflat = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
             for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{prefix}['{k}']")
        else:
            yield prefix, (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    assert dict(walk(ttree)) == jflat
    assert sorted(ttree["slots"]) == sorted(
        str(i) for i, k in enumerate(tcfg.pattern) if k != "shared_attn")
    train, _ = common.split_trainable(ttree)
    lora = [t for t in common.tree_leaves(train)]
    assert len(lora) == 8 and train["shared"]["attn"]["wq"]["lora_A"] is \
        ttree["shared"]["attn"]["wq"]["lora_A"]
    assert torch.equal(ttree["slots"]["0"]["A_log"][0], torch.log(
        torch.linspace(1.0, 16.0, 2)))


# -------------------------------------------------------- the SSD versions
def _ssd_inputs(seed, b, s, nh, hd, ds):
    """Model-layout inputs in test_kernels.py's ranges (dt = softplus,
    da = -0.1 softplus)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x, bm, cm = 0.5 * n(b, s, nh, hd), 0.3 * n(b, s, ds), 0.3 * n(b, s, ds)
    dt = np.log1p(np.exp(n(b, s, nh))).astype(np.float32)
    da = (-0.1 * np.log1p(np.exp(n(b, s, nh)))).astype(np.float32)
    return x, bm, cm, dt, da


def _per_head(x, bm, cm, dt, da):
    """Model layout -> the Pallas layout (BH, S, ...), B and C broadcast
    to every head."""
    b, s, nh, hd = x.shape
    ds = bm.shape[-1]

    def heads(t):
        return np.broadcast_to(t[:, :, None], (b, s, nh, ds))
    return (x.transpose(0, 2, 1, 3).reshape(b * nh, s, hd),
            heads(bm).transpose(0, 2, 1, 3).reshape(b * nh, s, ds),
            heads(cm).transpose(0, 2, 1, 3).reshape(b * nh, s, ds),
            dt.transpose(0, 2, 1).reshape(b * nh, s),
            da.transpose(0, 2, 1).reshape(b * nh, s))


def _to_model(y, b, nh):
    bh, s, hd = y.shape
    return np.asarray(y).reshape(b, nh, s, hd).transpose(0, 2, 1, 3)


# (batch, nh) over the BH rows of test_kernels.py's shapes (BH, S, hd, ds),
# then a ragged S, which the Pallas kernel does not take
SSD_CASES = [((1, 2), (2, 64, 16, 8), 16), ((1, 2), (2, 64, 16, 8), 64),
             ((1, 1), (1, 128, 64, 64), 16), ((1, 1), (1, 128, 64, 64), 64),
             ((2, 2), (4, 32, 8, 16), 16), ((2, 2), (4, 32, 8, 16), 64),
             ((2, 3), (6, 50, 16, 8), 16), ((1, 2), (2, 200, 64, 16), 128)]


@pytest.mark.parametrize("heads,shape,chunk", SSD_CASES,
                         ids=[f"{s}-chunk{c}" for _, s, c in SSD_CASES])
def test_ssd_plain_versions_match_jax(heads, shape, chunk):
    b, nh = heads
    bh, s, hd, ds = shape
    assert b * nh == bh
    x, bm, cm, dt, da = _ssd_inputs(bh * 100 + s, b, s, nh, hd, ds)
    px = _per_head(x, bm, cm, dt, da)
    want_exact = _to_model(jref.ssd_scan(*map(jnp.asarray, px)), b, nh)
    # the port's exact recurrence, in the Pallas layout, with its state
    got_exact, h_exact = ref.ssd_scan(
        *(torch.from_numpy(np.array(t)) for t in px), return_state=True)
    _close(_to_model(got_exact.numpy(), b, nh), want_exact, "f32",
           "ref.ssd_scan")
    # the chunked form in the model's layout, through the dispatch
    tin = [torch.from_numpy(np.ascontiguousarray(t))
           for t in (x, bm, cm, dt, da)]
    y, state = ops.ssd_scan(*tin, chunk=chunk, return_state=True)
    assert torch.equal(y, ops.ssd_scan(*tin, chunk=chunk))
    _of_scale(y, want_exact, 1e-4, "ops.ssd_scan vs the recurrence")
    _of_scale(state, h_exact.reshape(b, nh, hd, ds), 1e-4, "final state")
    if s % chunk == 0:
        want_pallas = _to_model(pallas_ssd_scan(
            *map(jnp.asarray, px), chunk=chunk, interpret=True), b, nh)
        _close(y, want_pallas, "f32", "ops.ssd_scan vs Pallas interpret")


def test_ssd_chunked_takes_strided_views_and_differentiates():
    """x, B and C as views into one (B, S, din + 2 ds) tensor, as
    mamba2_seq hands them over; autograd runs through the plain version."""
    b, s, nh, hd, ds = 2, 37, 2, 64, 16
    rng = np.random.default_rng(5)
    xbc = torch.from_numpy(
        0.4 * rng.standard_normal((b, s, nh * hd + 2 * ds)).astype(
            np.float32)).requires_grad_()
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    bm, cm = xbc[..., nh * hd:nh * hd + ds], xbc[..., nh * hd + ds:]
    _, _, _, dt, da = (torch.from_numpy(t) for t in _ssd_inputs(
        6, b, s, nh, hd, ds))
    y, state = ops.ssd_scan(x, bm, cm, dt, da, return_state=True)
    dense = [t.detach().contiguous() for t in (x, bm, cm)]
    y2, state2 = ref.ssd_chunked(*dense, dt, da)
    assert torch.equal(y.detach(), y2) and torch.equal(state.detach(),
                                                       state2)
    (y.square().sum() + state.sum()).backward()
    assert xbc.grad is not None and bool(xbc.grad.isfinite().all())
    assert float(xbc.grad.abs().max()) > 0


def test_ssd_wrapper_refuses_cpu_tensors_before_any_launch():
    """The kernel's wrapper launches on CUDA tensors or raises; the plain
    version is reached only through ``kernels.ops`` with a CPU tensor."""
    before = ssd_mod.launches
    x, bm, cm, dt, da = (torch.from_numpy(t) for t in _ssd_inputs(
        7, 1, 8, 1, 64, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd_scan(x, bm, cm, dt, da)
    assert ssd_mod.launches == before


# --------------------------------------------------------- the Mamba2 block
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba2_seq_and_decode_match_jax(dt):
    """One Mamba2 block: the sequence forward with its final conv history
    and state (S = 20, ragged against the chunk of 128; and S = 2, shorter
    than the conv history), then decode steps from the harvested cache."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(dt, seed=1)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["slots"]["0"])
    tl = T._layer(tp["slots"]["0"], 0)
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((B, S + 3, 64))).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])
    seq = jax.jit(lambda p, v: jssm.mamba2_seq(p, jcfg, v,
                                               return_state=True))
    dec = jax.jit(lambda p, v, c: jssm.mamba2_decode(p, jcfg, v, c))
    for s in (S, 2):
        jy, jst = seq(jl, jx[:, :s])
        ty, tst = ssm.mamba2_seq(tl, tcfg, tx[:, :s], return_state=True)
        assert ty.dtype == TDT[dt] and tst["conv"].dtype == torch.float32
        _close(ty, jy, dt, f"mamba2_seq S={s}")
        for name in ("conv", "state"):
            assert tst[name].shape == jst[name].shape
            _close(tst[name], jst[name], dt, f"{name} S={s}")
        assert torch.equal(ssm.mamba2_seq(tl, tcfg, tx[:, :s]), ty)
    # three decode steps from the S = 20 cache, updated in place
    _, jcache = seq(jl, jx[:, :S])
    _, tcache = ssm.mamba2_seq(tl, tcfg, tx[:, :S], return_state=True)
    conv0 = tcache["conv"]
    for t in range(S, S + 3):
        jy, jcache = dec(jl, jx[:, t:t + 1], jcache)
        ty, tcache = ssm.mamba2_decode(tl, tcfg, tx[:, t:t + 1], tcache)
        _close(ty, jy, dt, f"mamba2_decode t={t}")
        for name in ("conv", "state"):
            _close(tcache[name], jcache[name], dt, f"decode {name} t={t}")
    assert tcache["conv"] is conv0


# -------------------------------------------------------------- the model
def _f32_rule(got, want, want_f32, what: str) -> None:
    """bf16 through the whole hybrid: the port's bf16 result is as close to
    the f32 model's (the same bf16 weights, upcast) as the reference's
    bf16 result is, within 25% on the mean and on the root-mean-square
    error.  ``got``, ``want`` and ``want_f32`` may be lists of tensors,
    each then scaled by its own max|want_f32| and pooled.  The largest
    error is not compared: it is the tail of a random walk of 1-ulp
    flips, and varies by +-60% between two paths that are equally close
    on average; for the same reason single small tensors are pooled."""
    if not isinstance(got, list):
        got, want, want_f32 = [got], [want], [want_f32]
    e_got, e_ref = [], []
    for g, w, w32 in zip(got, want, want_f32, strict=True):
        g, w, w32 = _np(g), _np(w), _np(w32)
        assert g.shape == w.shape == w32.shape, what
        scale = max(float(np.abs(w32).max()), 1e-30)
        e_got.append(np.abs(g - w32).ravel() / scale)
        e_ref.append(np.abs(w - w32).ravel() / scale)
    e_got, e_ref = np.concatenate(e_got), np.concatenate(e_ref)
    for stat, f in (("mean", np.mean),
                    ("rms", lambda e: np.sqrt(np.mean(np.square(e))))):
        g, r = float(f(e_got)), float(f(e_ref))
        assert g <= 1.25 * r, (what, stat, g, r)


def _upcast(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_seq_logits(dt):
    """f32: the port's logits against the reference's at 1e-4.  bf16: the
    two sides round at other places (the attention keeps ``q * scale`` and
    the probabilities in f32, as the Pallas kernel does, where the XLA
    twin rounds them; a 1-ulp flip in the residual stream of an attention
    block), and over the 19 blocks such flips reach ~3% of the logits'
    scale on both sides alike, so bf16 is held by ``_f32_rule``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(dt)
    tok = _tokens(11, (B, S))
    fwd = jax.jit(lambda p, t: jT.forward_seq(jcfg, p, t))
    want = fwd(jp, jnp.asarray(tok))
    got = T.forward_seq(tcfg, tp, torch.from_numpy(tok).long())
    assert got["logits"].shape == (B, S, tcfg.vocab)
    assert got["logits"].dtype == TDT[dt]
    assert float(got["aux_loss"]) == 0.0
    if dt == "f32":
        _close(got["logits"], want["logits"], dt, "logits")
        _close(got["hidden"], want["hidden"], dt, "hidden")
        return
    want32 = fwd(_upcast(jp), jnp.asarray(tok))
    for name in ("logits", "hidden"):
        _f32_rule(got[name], want[name], want32[name], name)


def _jax_prefill_decode(jcfg, jp, tok, p, cdt):
    """The reference's prefill(p) logits and cache, then its decode logits
    and cache after tokens p..S-1."""
    jlog, jcache = jax.jit(lambda pr, t: jT.prefill(
        jcfg, pr, t, cache_len=S, cache_dtype=cdt))(jp, jnp.asarray(tok[:, :p]))
    pre = (jlog, jcache)
    dec = jax.jit(lambda pr, c, t: jT.decode_step(jcfg, pr, c, t))
    logits = []
    for t in range(p, S):
        jl, jcache = dec(jp, jcache, jnp.asarray(tok[:, t:t + 1]))
        logits.append(jl)
    return pre, logits, jcache


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_cache_and_decode_steps(dt):
    """prefill(P): every slot's cache piece (conv, state, k, v) and the
    logits, then 4 decode steps, against JAX; weights and K/V cache in
    ``dt``.  f32: each tensor to 1e-4.  bf16: ``_f32_rule`` against the
    reference's f32 model with an f32 cache, the cache pieces pooled
    (``test_blocks_in_bf16_one_at_a_time`` holds each piece to 2e-2)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(dt, seed=3)
    tok = _tokens(12, (B, S))
    p = S - 4
    (jlog, jcache0), jdec, jcache = _jax_prefill_decode(jcfg, jp, tok, p,
                                                        JDT[dt])
    tlog, tcache = T.prefill(tcfg, tp, torch.from_numpy(tok[:, :p]).long(),
                             cache_len=S, cache_dtype=TDT[dt])
    assert tcache["pos"] == int(jcache0["pos"]) == p
    assert sorted(tcache["slots"]) == sorted(jcache0["slots"])
    names = [(str(i), name) for i in range(len(tcfg.pattern))
             for name in sorted(jcache0["slots"][str(i)])]
    for i, name in names:
        got, want = tcache["slots"][i][name], jcache0["slots"][i][name]
        assert got.shape == want.shape, (i, name)
        assert str(got.dtype)[6:] == str(want.dtype), (i, name)
    pieces0 = [tcache["slots"][i][name].clone() for i, name in names]
    tdec = []
    for t in range(p, S):
        tl, tcache = T.decode_step(tcfg, tp, tcache,
                                   torch.from_numpy(tok[:, t:t + 1]).long())
        assert tl.shape == (B, tcfg.vocab)
        tdec.append(tl)
    assert tcache["pos"] == S
    pieces = [tcache["slots"][i][name] for i, name in names]
    want0 = [jcache0["slots"][i][name] for i, name in names]
    want1 = [jcache["slots"][i][name] for i, name in names]
    if dt == "f32":
        _close(tlog, jlog, dt, "prefill logits")
        for (i, name), got, want in zip(names, pieces0, want0):
            _close(got, want, dt, f"prefill slot {i} {name}")
        for t, (got, want) in enumerate(zip(tdec, jdec)):
            _close(got, want, dt, f"decode logits {t}")
        for (i, name), got, want in zip(names, pieces, want1):
            _close(got, want, dt, f"decoded slot {i} {name}")
        return
    (r_log, r_cache0), r_dec, r_cache = _jax_prefill_decode(
        jcfg, _upcast(jp), tok, p, jnp.float32)
    _f32_rule(tlog, jlog, r_log, "prefill logits")
    _f32_rule(pieces0, want0, [r_cache0["slots"][i][name]
                               for i, name in names], "prefill cache")
    _f32_rule(tdec, jdec, r_dec, "decode logits")
    _f32_rule(pieces, want1, [r_cache["slots"][i][name]
                              for i, name in names], "decoded cache")


def test_blocks_in_bf16_one_at_a_time():
    """Each of the 19 blocks in bf16, fed the reference's own input to it:
    the output and the collected cache piece within 2e-2 of the scale.
    (At this grain the Mamba2 blocks agree bit for bit but for rare 1-ulp
    flips, and an attention block within a bf16 ulp of the residual.)"""
    jcfg, tcfg = _cfgs()
    jp, tp = _params("bf16", seed=3)
    tok = _tokens(12, (B, S))
    x = jnp.take(jp["embed"], jnp.asarray(tok), axis=0)
    pos = jnp.arange(S)
    for i, kind in enumerate(jcfg.pattern):
        jblock = jp["shared"] if kind == "shared_attn" else \
            jax.tree_util.tree_map(lambda a: a[0], jp["slots"][str(i)])
        want, jpiece = jax.jit(lambda p, v, kind=kind: jT.block_seq(
            kind, p, jcfg, v, pos, None, True)[::2])(jblock, x)
        xin = bridge.to_torch(np.asarray(x), device="cpu")
        got, _, piece = T.block_seq(kind, T._slot_params(tcfg, tp, i, 0),
                                    tcfg, xin, torch.arange(S),
                                    collect_kv=True)
        _close(got, want, "bf16", f"block {i} ({kind})")
        assert sorted(piece) == sorted(jpiece)
        for name in piece:
            _close(piece[name], jpiece[name], "bf16", f"block {i} {name}")
        x = want


def test_decode_after_prefill_matches_teacher_forced_forward():
    """Within the port: decode after prefill(S) gives forward_seq's logits
    at position S (f32 cache); the Mamba2 states carry the prefix."""
    _, tcfg = _cfgs()
    _, tp = _params("f32", seed=4)
    tok = torch.from_numpy(_tokens(13, (B, S + 1))).long()
    full = T.forward_seq(tcfg, tp, tok)["logits"]
    _, cache = T.prefill(tcfg, tp, tok[:, :S], cache_len=S + 4,
                         cache_dtype=torch.float32)
    logits, _ = T.decode_step(tcfg, tp, cache, tok[:, S:])
    np.testing.assert_allclose(_np(logits), _np(full[:, S]), **F32)


# --------------------------------------------------------------- the rollout
def test_generate_and_rollout_batch_with_injected_gumbel_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("f32", seed=5)
    n_prompt, max_new, m = 4, 8, 2
    length_tol = max(4, max_new // 2)
    prompt = _tokens(14, (B, n_prompt))
    key = jax.random.PRNGKey(7)
    jtok, jlp, jmask = jgenerate(jcfg, jp, jnp.asarray(prompt), key,
                                 max_new=max_new)
    noise = torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(k, (B, tcfg.vocab)))
        for k in jax.random.split(key, max_new)]))
    tprompt = torch.from_numpy(prompt).long()
    ttok, tlp, tmask = generate(tcfg, tp, tprompt, max_new=max_new,
                                gumbel=noise)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # the bf16 K/V cache of both sides' generate: see the module docstring
    _close(tlp, jlp, "bf16", "sampling logprobs")
    bh, bx = rewards.variant_bands(tcfg.vocab)
    batch = rollout_batch(tcfg, tp, tp, tprompt, bh, bx, n_objectives=m,
                          max_new=max_new, length_tol=length_tol,
                          gumbel=noise)
    assert torch.equal(batch.tokens, ttok) and torch.equal(batch.old_logprobs,
                                                           tlp)
    jref_lp = jppo.token_logprobs(jax.jit(lambda p, t: jT.forward_seq(
        jcfg, p, t))(jp, jtok)["logits"], jtok)
    _close(batch.ref_logprobs, jref_lp, "f32", "reference logprobs")
    jbh, jbx = jrewards.variant_bands(jcfg.vocab)
    jr = jrewards.score_batch_banded(jbh, jbx, jtok, jmask, m, length_tol)
    np.testing.assert_allclose(batch.rewards.numpy(), np.asarray(jr),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ serve and training
def test_serve_cli_runs_zamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--max-new", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "zamba2-1.2b-smoke" in capsys.readouterr().out


def test_federated_trainer_refuses_a_hybrid_config():
    """(The name is from when the trainer refused a hybrid; it is kept so
    the test's id stays the same.  What it checks now: the trainer takes
    hybrids.)  The trainer takes the zamba2 hybrid (training it is held to
    the JAX package in ``test_torch_hybrid_training.py``) and, every kind
    being ported, a Mamba2 + mLSTM hybrid too: without adapters every
    parameter is trainable, and a round runs."""
    _, tcfg = _cfgs()
    tr = FederatedTrainer(tcfg, FIRMConfig(n_clients=2), device="cpu")
    assert tr.d_trainable == sum(
        t.numel() for t in common.tree_leaves(tr.global_trainable))
    assert all(t is None for t in common.tree_leaves(
        tr.global_trainable["slots"]))
    mlstm = dataclasses.replace(tcfg, pattern=("mamba2", "mlstm"),
                                n_layers=2)
    tr = FederatedTrainer(mlstm, FIRMConfig(n_clients=2, local_steps=1,
                                            batch_size=2),
                          EngineConfig(prompt_len=4, max_new=4),
                          device="cpu")
    assert tr.d_trainable == sum(t.numel() for t in
                                 common.tree_leaves(tr.params))
    summary = tr.run_round()
    assert summary["param_drift"] > 0 and np.isfinite(summary["kl"])
