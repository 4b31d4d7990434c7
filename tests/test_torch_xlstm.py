"""The port's xLSTM blocks and full-parameter FIRM on xlstm-125m against
the JAX package, on the CPU at a tiny size.

The config is ``get_config("xlstm-125m").reduced(n_layers=3, d_model=64,
vocab=64)``: one period of (mLSTM, mLSTM, sLSTM), 4 heads of 16.  Both
sides get the same numpy inputs and the same parameters: the JAX model's
``init_params`` carried over by ``repro_torch.bridge`` (xlstm has no
adapters, so every parameter is trainable and the round moves, and sends,
all of them).  The mLSTM runs chunkwise at chunks of 8 (S = 20: two
chunks and a ragged tail of 4) and 5 (four whole chunks), and as the
exact recurrence (``mlstm_chunk = 0``).

Tolerances, as in ``test_torch_models.py``: f32 1e-4; bf16 2e-2 of the
compared tensor's scale, ``|got - want| <= 2e-2 * max(1, max|want|)``.
The local step and the rounds are held in f32 (the embedding's gradient
is a scatter-add, summed in another order on each side): f32 results
within 1e-4 of their scale, Adam's steps within 1e-2 of theirs (where
|g| is near Adam's eps the step is sensitive to the last bits of g), KL
within 1e-6 absolute, bytes exact, as ``test_torch_hybrid_training.py``
holds zamba2's.  The round's bf16 paths (delta, flat rows, FedAvg,
drift, Gram over mixed bf16 and f32 leaves, Adam on bf16 leaves) are
held to the reference on bf16 trees: bit for bit where both sides
compute the same IEEE operations, else to an f32 or bf16 ulp.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comms import codec as jcodec  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import FIRMConfig as JFIRMConfig  # noqa: E402
from repro.core import drift as jdrift  # noqa: E402
from repro.data.partition import sample_prompt_block  # noqa: E402
from repro.fed import engine as jengine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.rlhf import local as jlocal  # noqa: E402
from repro.rlhf import ppo as jppo  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch import bridge, trees  # noqa: E402
from repro_torch.comms import codec as codec_lib, make_codec  # noqa: E402
from repro_torch.configs import FIRMConfig, get_config  # noqa: E402
from repro_torch.core import drift  # noqa: E402
from repro_torch.fed import engine  # noqa: E402
from repro_torch.fed.engine import EngineConfig, FederatedTrainer  # noqa
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common, transformer as T, xlstm  # noqa: E402
from repro_torch.rlhf import local, ppo  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ARCH = "xlstm-125m"
B, S = 2, 20
P, MAX_NEW, M = 6, 8, 2
SR = P + MAX_NEW
C, ROUNDS = 2, 2
TOL, STEP_TOL, KL_ATOL = 1e-4, 1e-2, 1e-6
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
MODES = {"chunk8_ragged": 8, "chunk5": 5, "recurrent": 0}


def _cfgs(chunk=None):
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(ARCH).reduced(n_layers=3, d_model=64, vocab=64)
        if chunk is not None:
            cfg = dataclasses.replace(cfg, mlstm_chunk=chunk)
        out.append(cfg)
    return tuple(out)


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


def assert_of_scale(got, want, tol, what=""):
    """|got - want| <= tol * max|want|, element for element."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    limit = tol * float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def _params(jcfg, dt="f32", seed=0):
    """(JAX tree, port tree) holding the same values: the reference's
    init in ``dt`` (its f32 gate weights stay f32)."""
    tree = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jcfg, jax.random.PRNGKey(seed),
                                   dtype=JDT[dt]))
    # a non-zero sLSTM bias, so that the bias path is exercised
    rng = np.random.default_rng(seed)
    for slot in tree["slots"].values():
        if "r" in slot:
            slot["b"] = rng.normal(0, 0.3, slot["b"].shape).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        bridge.to_torch(tree, device="cpu")


def _x(seed, shape, dt):
    x = 0.5 * np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


def _block(tree, i: int):
    """Slot ``i``'s block of period 0, from a JAX or a port tree."""
    slot = tree["slots"][str(i)]
    if isinstance(jax.tree_util.tree_leaves(slot)[0], torch.Tensor):
        return common.tree_map(lambda t: t[0], slot)
    return jax.tree_util.tree_map(lambda a: a[0], slot)


# ----------------------------------------------------------------- configs
def test_config_tree_and_param_count_match_reference():
    jfull, tfull = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(jfull) == dataclasses.asdict(tfull)
    assert tfull.lora is None and tfull.mlstm_chunk == 128
    assert tfull.param_count() == jfull.param_count()
    jcfg, tcfg = _cfgs()
    jtree = jT.init_params(jcfg, jax.random.PRNGKey(0))
    ttree = T.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    jflat = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
             for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = {jax.tree_util.keystr(p): (tuple(x.shape),
                                      str(x.dtype).replace("torch.", ""))
             for p, x in jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert tflat == jflat
    # no adapters: every parameter is trainable, nothing is frozen
    train, frozen = common.split_trainable(ttree)
    assert train is ttree and not trees.tree_leaves(frozen)
    # the bridge carries the f32 gate weights and the bf16 rest both ways
    back = bridge.to_numpy(ttree)
    for p, a in jax.tree_util.tree_flatten_with_path(back)[0]:
        assert str(a.dtype) == jflat[jax.tree_util.keystr(p)][1]


def test_full_width_tree_holds_the_reference_parameters():
    """xlstm-125m at full width on the meta device: 115,087,104
    parameters, 11,857,920 of them f32 (``w_if`` and sLSTM's ``w``, ``r``
    and ``b``), as the reference's tree holds."""
    tree = T.init_params(get_config(ARCH), generator=torch.Generator(),
                         device="meta")
    leaves = trees.tree_leaves(tree)
    assert sum(t.numel() for t in leaves) == 115_087_104
    assert sum(t.numel() for t in leaves
               if t.dtype == torch.float32) == 11_857_920


# ----------------------------------------------------- mixed-dtype linear
def test_linear_promotes_mixed_dtypes_as_jax():
    """bf16 @ f32 (mLSTM's ``w_if``) runs in f32 and gives f32, as JAX
    promotes it."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    jx16 = jnp.asarray(x).astype(jnp.bfloat16)
    want = jcommon.linear({"w": jnp.asarray(w)}, jx16)
    got = common.linear({"w": _t(w)}, _t(x).bfloat16())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # and an f32 input against a bf16 weight
    got2 = common.linear({"w": _t(w).bfloat16()}, _t(x))
    want2 = jcommon.linear({"w": jnp.asarray(w).astype(jnp.bfloat16)},
                           jnp.asarray(x))
    assert got2.dtype == torch.float32
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_linear_same_dtype_is_unchanged_bit_for_bit(dt):
    """A same-dtype product is the plain ``x @ w`` (plus the LoRA path),
    bit for bit: the promotion touches nothing else."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 7, 32), generator=g).to(TDT[dt])
    p = {"w": torch.randn((32, 16), generator=g).to(TDT[dt]),
         "lora_A": torch.randn((32, 4), generator=g),
         "lora_B": torch.randn((4, 16), generator=g)}
    want = x @ p["w"] + (32.0 / 4) * ((x.float() @ p["lora_A"])
                                       @ p["lora_B"]).to(TDT[dt])
    got = common.linear(p, x)
    assert got.dtype == TDT[dt] and torch.equal(got, want)
    assert torch.equal(common.linear({"w": p["w"]}, x), x @ p["w"])


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 256), (3, 1001)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_dg_plain_matches_jax_vjp(shape, dt):
    """The gradient of the norm's g (trained here: xlstm has no adapters):
    the plain formula the card's kernel is held to (``ref.rmsnorm_dg``)
    against ``jax.vjp`` of the reference's plain forward and autograd of
    the port's; f32 1e-5, bf16 1e-2 of the scale (the f32 sums over the
    rows, in other orders, each rounded once to bf16)."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    rng = np.random.default_rng(sum(shape))
    x, g, dy = (rng.standard_normal(s).astype(np.float32)
                for s in (shape, shape[-1:], shape))
    jx, jg, jdy = (jnp.asarray(a).astype(JDT[dt]) for a in (x, g, dy))
    _, vjp = jax.vjp(lambda b: jref.rmsnorm(jx, b), jg)
    want = vjp(jdy)[0]
    tx, tg, tdy = (_t(np.asarray(a.astype(jnp.float32))).to(TDT[dt])
                   for a in (jx, jg, jdy))
    got = ref.rmsnorm_dg(tx, tg, tdy)
    assert got.dtype == tg.dtype and got.shape == tg.shape
    tol = 1e-5 if dt == "f32" else 1e-2
    assert_close(got, want, tol, "rmsnorm dg vs jax.vjp")
    ga = tg.clone().requires_grad_()
    ref.rmsnorm(tx, ga).backward(tdy)
    assert_close(got, ga.grad, tol, "rmsnorm dg vs autograd")


def _kernel_dg_order(x, dy, max_groups, eps=1e-5):
    """The dg of ``csrc/rmsnorm.cu``'s backward in its summation order, on
    the CPU: the rows in groups of ``per = ceil(rows / max_groups)``, each
    group's terms added row after row in f32, then 32 lanes each adding a
    fixed stride of the groups' partials, the lane sums added in order."""
    rows, d = x.shape
    per = -(-rows // max_groups)
    groups = -(-rows // per)
    xf = x.float()
    r = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / d + eps)
    terms = (dy * (xf * r).to(x.dtype)).float()
    terms = torch.cat([terms, terms.new_zeros((groups * per - rows, d))])
    part = torch.zeros((groups, d))
    for j in range(per):
        part += terms[j::per]
    lanes = torch.zeros((32, d))
    for k in range(0, groups, 32):
        chunk = part[k:k + 32]
        lanes[:chunk.shape[0]] += chunk
    total = torch.zeros(d)
    for lane in lanes:
        total += lane
    return total.to(x.dtype)


@pytest.mark.parametrize("shape", [(2100, 64), (4099, 32), (5, 48)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_dg_kernel_order_matches_the_f64_sum(shape, dt):
    """The card's dg sums the rows in groups (at most ``kDgMaxGroups``,
    read from the source, so here 1-5 rows a group, the last one shorter)
    and then the groups by lanes.  That order, modelled on the CPU, against
    the f64 sum of the same rounded terms (within 1e-5 of the scale in
    f32, one bf16 ulp of it in bf16), the plain formula, and in f32
    ``jax.vjp`` of the reference's plain forward (1e-5).  JAX's bf16 vjp
    is not the yardstick at thousands of rows: on the CPU it sums in bf16,
    1.4 off the f64 sum at (4099, 32) where the scale is 108.  The source
    adds with no atomics."""
    import re

    from repro.kernels import ref as jref
    from repro_torch.kernels import build, ref
    src = (build.CSRC / "rmsnorm.cu").read_text()
    max_groups = int(re.search(r"kDgMaxGroups = (\d+)", src).group(1))
    rng = np.random.default_rng(sum(shape) + 1)
    x, g, dy = (rng.standard_normal(s).astype(np.float32)
                for s in (shape, shape[-1:], shape))
    jx, jg, jdy = (jnp.asarray(a).astype(JDT[dt]) for a in (x, g, dy))
    tx, tg, tdy = (_t(np.asarray(a.astype(jnp.float32))).to(TDT[dt])
                   for a in (jx, jg, jdy))
    got = _kernel_dg_order(tx, tdy, max_groups)
    assert got.dtype == tg.dtype and got.shape == tg.shape
    xf = tx.float()
    n = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)
         ).to(tx.dtype)
    exact = (tdy * n).double().sum(0)
    tol = 1e-5 if dt == "f32" else 2.0 ** -8
    assert_close(got.double(), exact, tol, "kernel-order dg vs f64 sum")
    assert_close(got, ref.rmsnorm_dg(tx, tg, tdy), tol,
                 "kernel-order dg vs the plain formula")
    if dt == "f32":
        _, vjp = jax.vjp(lambda b: jref.rmsnorm(jx, b), jg)
        assert_close(got, vjp(jdy)[0], tol, "kernel-order dg vs jax.vjp")
    # one order every call: no atomic adds
    assert "atomicAdd" not in src


# ------------------------------------------------------------- the blocks
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_mlstm_block_matches_reference(mode, dt):
    """The mLSTM block, sequence (output and final C, n, m) and one decode
    step from that state, against the reference's."""
    jcfg, tcfg = _cfgs(MODES[mode])
    jp, tp = _params(jcfg, dt, seed=1)
    jb, tb = _block(jp, 0), _block(tp, 0)
    jxs, txs = _x(2, (B, S, jcfg.d_model), dt)
    want, jst = jax.jit(lambda p, v: jx.mlstm_seq(
        p, jcfg, v, return_state=True))(jb, jxs)
    got, tst = xlstm.mlstm_seq(tb, tcfg, txs, return_state=True)
    _close(got, want, dt, "mlstm out")
    for name in ("C", "n", "m"):
        assert tst[name].dtype == torch.float32
        _close(tst[name], jst[name], dt, f"mlstm {name}")
    jx1, tx1 = _x(3, (B, 1, jcfg.d_model), dt)
    want1, jc = jax.jit(lambda p, v, c: jx.mlstm_decode(p, jcfg, v, c))(
        jb, jx1, jst)
    cache = {k: v.clone() for k, v in tst.items()}
    got1, tc = xlstm.mlstm_decode(tb, tcfg, tx1, cache)
    _close(got1, want1, dt, "mlstm decode")
    for name in ("C", "n", "m"):
        assert tc[name] is cache[name]              # updated in place
        _close(tc[name], jc[name], dt, f"mlstm decode {name}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_slstm_block_matches_reference(dt):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, dt, seed=4)
    jb, tb = _block(jp, 2), _block(tp, 2)
    jxs, txs = _x(5, (B, S, jcfg.d_model), dt)
    want, jst = jax.jit(lambda p, v: jx.slstm_seq(
        p, jcfg, v, return_state=True))(jb, jxs)
    got, tst = xlstm.slstm_seq(tb, tcfg, txs, return_state=True)
    _close(got, want, dt, "slstm out")
    for name in ("c", "n", "h", "m"):
        _close(tst[name], jst[name], dt, f"slstm {name}")
    jx1, tx1 = _x(6, (B, 1, jcfg.d_model), dt)
    want1, jc = jax.jit(lambda p, v, c: jx.slstm_decode(p, jcfg, v, c))(
        jb, jx1, jst)
    cache = {k: v.clone() for k, v in tst.items()}
    got1, tc = xlstm.slstm_decode(tb, tcfg, tx1, cache)
    _close(got1, want1, dt, "slstm decode")
    for name in ("c", "n", "h", "m"):
        assert tc[name] is cache[name]
        _close(tc[name], jc[name], dt, f"slstm decode {name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_seq_matches_stepwise(kind):
    """The reference's own check (``test_models.py``) on the port: the
    sequence forward equals the decode steps one token at a time (f32)."""
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    init = {"mlstm": xlstm.init_mlstm, "slstm": xlstm.init_slstm}[kind]
    seqf = {"mlstm": xlstm.mlstm_seq, "slstm": xlstm.slstm_seq}[kind]
    decf = {"mlstm": xlstm.mlstm_decode, "slstm": xlstm.slstm_decode}[kind]
    cachef = {"mlstm": xlstm.init_mlstm_cache,
              "slstm": xlstm.init_slstm_cache}[kind]
    p = init(tcfg, generator=g, device="cpu", dtype=torch.float32)
    b, s = 1, 12
    x = 0.5 * torch.randn((b, s, tcfg.d_model), generator=g)
    y_seq = seqf(p, tcfg, x)
    cache = cachef(tcfg, b, device="cpu")
    ys = []
    for t in range(s):
        y_t, cache = decf(p, tcfg, x[:, t:t + 1], cache)
        ys.append(y_t)
    np.testing.assert_allclose(y_seq.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_chunked_mlstm_gradients_match_reference():
    """The chunkwise form's gradients (the -inf causal mask, the -1e30
    floor, a ragged tail) against ``jax.grad``: finite, within 1e-4."""
    jcfg, tcfg = _cfgs(8)
    jp, tp = _params(jcfg, "f32", seed=7)
    jb, tb = _block(jp, 0), _block(tp, 0)
    jxs, txs = _x(8, (B, S, jcfg.d_model), "f32")
    jg = jax.grad(lambda p, v: jnp.sum(jx.mlstm_seq(p, jcfg, v) ** 2),
                  argnums=(0, 1))(jb, jxs)
    tb = common.tree_map(lambda t: t.requires_grad_(), tb)
    txs.requires_grad_()
    (xlstm.mlstm_seq(tb, tcfg, txs) ** 2).sum().backward()
    assert_close(txs.grad, jg[1], TOL, "dx")
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jg[0])[0],
            common.tree_leaves(tb)):
        assert torch.isfinite(got.grad).all()
        assert_close(got.grad, want, TOL, jax.tree_util.keystr(path))


# -------------------------------------------------------------- the model
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_prefill_and_decode_match_reference(dt):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, dt, seed=9)
    tok = _tokens(10, (B, S))
    want = jax.jit(lambda p, t: jT.forward_seq(jcfg, p, t))(
        jp, jnp.asarray(tok))
    got = T.forward_seq(tcfg, tp, torch.from_numpy(tok).long())
    # bf16 through three blocks: the f32 rule's 2e-2 of the logits' scale
    _close(got["logits"], want["logits"], dt, "logits")
    s0 = S - 4
    jl, jcache = jax.jit(lambda p, t: jT.prefill(jcfg, p, t, cache_len=S))(
        jp, jnp.asarray(tok[:, :s0]))
    tl, tcache = T.prefill(tcfg, tp, torch.from_numpy(tok[:, :s0]).long(),
                           cache_len=S)
    _close(tl, jl, dt, "prefill logits")
    for i in ("0", "1", "2"):
        for name, piece in tcache["slots"][i].items():
            _close(piece, jcache["slots"][i][name], dt, f"cache {i} {name}")
    jstep = jax.jit(lambda p, c, t: jT.decode_step(jcfg, p, c, t))
    for t in range(s0, S):
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok[:, t:t + 1]))
        tlog, tcache = T.decode_step(tcfg, tp, tcache,
                                     torch.from_numpy(tok[:, t:t + 1]).long())
        _close(tlog, jlog, dt, f"decode {t}")
    assert int(tcache["pos"]) == S
    for i in ("0", "1", "2"):
        for name, piece in tcache["slots"][i].items():
            _close(piece, jcache["slots"][i][name], dt,
                   f"cache after decode {i} {name}")


# ------------------------------------------------- full-parameter FIRM
def _batch(jcfg, jparams, seed=0):
    """A PPO batch made on the JAX side, as (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, SR)).astype(np.int32)
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


def test_full_parameter_firm_local_step_matches_reference():
    """One local FIRM step with every parameter trainable (xlstm has no
    adapters): the M pulls through the mLSTM chunks and the sLSTM
    recurrence, the Gram, the MGDA solve, Adam on every leaf."""
    jcfg, tcfg = _cfgs(8)
    jfc = dataclasses.replace(JFIRMConfig(), n_objectives=M, batch_size=B)
    tfc = dataclasses.replace(FIRMConfig(), n_objectives=M, batch_size=B)
    jp, tp = _params(jcfg, "f32", seed=11)
    jtrain, jfrozen = jcommon.split_trainable(jp)
    ttrain, tfrozen = common.split_trainable(tp)
    jb, tb = _batch(jcfg, jp, seed=12)
    js = jlocal.init_client_state(jtrain, M, jcfg.d_model, kl_coef=0.1)
    rng = np.random.default_rng(13)
    js = js._replace(critic={"w": jnp.asarray(
        rng.normal(0, 0.3, (M, jcfg.d_model)), jnp.float32)},
        lam=jnp.asarray([0.3, 0.7], jnp.float32),
        step=jnp.asarray(2, jnp.int32))
    ts = bridge.client_state_to_torch(jax.tree_util.tree_map(np.asarray, js),
                                      device="cpu")
    jnew, jm = jlocal.firm_local_step(jcfg, jfc, js, jfrozen, jb)
    tnew, tm = local.firm_local_step(tcfg, tfc, ts, tfrozen, tb)
    assert set(tm) == set(jm)
    for key in jm:
        assert_close(tm[key], jm[key], TOL, key)
    for name, got, want in (("mu", tnew.opt.mu, jnew.opt.mu),
                            ("nu", tnew.opt.nu, jnew.opt.nu)):
        for i, (g, w) in enumerate(zip(common.tree_leaves(got),
                                       jax.tree_util.tree_leaves(want))):
            assert_close(g, w, TOL, f"adam {name} {i}")
    lr = tfc.actor_lr
    for i, (tn, to, jn, jo) in enumerate(zip(
            common.tree_leaves(tnew.trainable),
            common.tree_leaves(ts.trainable),
            jax.tree_util.tree_leaves(jnew.trainable),
            jax.tree_util.tree_leaves(js.trainable))):
        assert_close((tn - to) / lr, (_np(jn) - _np(jo)) / lr, STEP_TOL,
                     f"Adam step {i}")
    # every leaf moved, the embedding and the f32 gate weights included
    assert all(bool((tn != to).any()) for tn, to in zip(
        common.tree_leaves(tnew.trainable), common.tree_leaves(ts.trainable)))


def _bf16_stacked(seed):
    """(JAX, port) stacked trees of C = 2 clients and their anchor with
    xlstm's mix of bf16 and f32 leaves."""
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg, "bf16", seed=seed)
    rng = np.random.default_rng(seed)
    moved = [jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32) + rng.normal(
            0, 1e-2, a.shape)).astype(a.dtype), jax.tree_util.tree_map(
                np.asarray, jp)) for _ in range(C)]
    jstacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *moved)
    return (jax.tree_util.tree_map(jnp.asarray, jstacked), jp,
            bridge.to_torch(jstacked, device="cpu"), tp)


def test_round_paths_round_bf16_leaves_where_the_reference_rounds():
    """The delta (the f32 difference of the bf16 leaves, as the
    reference's jitted program computes it), the flat rows, FedAvg's
    apply (the mean cast back to bf16, then added in bf16) and the drift
    over xlstm's bf16 and f32 leaves, against the reference's own
    programs; the Gram over mixed leaves; Adam on bf16 leaves."""
    jst, janc, tst, tanc = _bf16_stacked(21)
    jflat = jengine._delta_flat_jit(jst, janc)
    tflat = engine._delta_flat(tst, tanc)
    assert tflat.dtype == torch.float32
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    j0, jspec = jcodec.tree_to_flat(jax.tree_util.tree_map(lambda a: a[0],
                                                           jst))
    t0, tspec = codec_lib.tree_to_flat(common.tree_map(lambda t: t[0], tst))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    assert [str(d).replace("torch.", "") for d in tspec.dtypes] == \
        [str(d) for d in jspec.dtypes]
    zero = np.zeros(C, np.float32)
    jagg = jengine._jit_flat_aggregate(jspec)(janc, jflat, jnp.asarray(zero),
                                              0.5)
    tagg = engine._flat_aggregate(tanc, tflat, zero, 0.5, tspec)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jagg)[0],
                            common.tree_leaves(tagg)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _np(w),
                                      err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(
        float(drift.param_drift_stacked(tst)),
        float(jdrift.param_drift_stacked(jst)), rtol=1e-6)
    grads = [common.tree_map(lambda t, i=i: t[i], tst) for i in range(C)]
    jgrads = [jax.tree_util.tree_map(lambda a, i=i: a[i], jst)
              for i in range(C)]
    np.testing.assert_allclose(
        ops.gram_from_pytrees(grads).numpy(),
        np.asarray(jops.gram_from_pytrees(jgrads, use_pallas=False)),
        rtol=TOL)
    # Adam on bf16 parameters: f32 moments, the update rounded once to bf16
    jopt = joptim.adam_init(janc)
    topt = optim.adam_init(tanc)
    jn, jo, _ = joptim.adam_update(jgrads[0], jopt, janc, lr=1e-3,
                                   max_grad_norm=1.0)
    tn, to, _ = optim.adam_update(grads[0], topt, tanc, lr=1e-3,
                                  max_grad_norm=1.0)
    for g, w in zip(common.tree_leaves(tn), jax.tree_util.tree_leaves(jn)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        # within one ulp of the leaf's own dtype
        ulp = 2.0 ** -7 if g.dtype == torch.bfloat16 else 2.0 ** -23
        np.testing.assert_allclose(_np(g), _np(w), rtol=ulp, atol=1e-6)
    for g, w in zip(common.tree_leaves(to.mu),
                    jax.tree_util.tree_leaves(jo.mu)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-9)


# ----------------------------------------------------------- the rounds
def _gumbel(key, n: int, shape) -> np.ndarray:
    return np.stack([np.asarray(jax.random.gumbel(k, shape))
                     for k in jax.random.split(key, n)])


def _round_draws(jtr, jcfg):
    """The next JAX round's draws (K = 1, every client), replayed from its
    key: the port's injected draws."""
    rng = jtr._rng
    rng, _down = jax.random.split(rng)
    keys = []
    for _ in range(2 * C):
        rng, kk = jax.random.split(rng)
        keys.append(kk)
    gen, up = keys[:C], keys[C:]
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
    return {"prompts": torch.from_numpy(prompts).long(),
            "gumbel": torch.from_numpy(gumbel),
            "up_bits": torch.from_numpy(bits)}


@pytest.fixture(scope="module")
def wan_rounds():
    """Two ``wan`` rounds of the JAX vectorized executor (f32 weights) and
    of one port trainer loaded from its state before round 1 and then
    carried on its own state and residuals, each round fed the JAX
    round's draws.  Returns (JAX summaries, port summaries, the port's
    ``ref_params`` before and after, the port trainer)."""
    jcfg, tcfg = _cfgs(8)
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
    leaves, treedef = jax.tree_util.tree_flatten(trainable)
    jtr._delta_spec = jcodec.TreeSpec(treedef, tuple(x.shape for x in leaves),
                                      tuple(x.dtype for x in leaves))
    ttr = FederatedTrainer(
        tcfg, tfc, EngineConfig(prompt_len=P, max_new=MAX_NEW,
                                uplink_codec="int8+ef"), device="cpu",
        params=bridge.to_torch(jax.tree_util.tree_map(np.asarray, params32),
                               device="cpu"))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    bridge.load_trainer_state(ttr, {
        "global_trainable": host(jtr.global_trainable),
        "client_states": [host(s) for s in jtr.client_states],
        "uplink_state": [None] * C,
        "prompt_counts": [ds._count for ds in jtr.datasets]})
    ref_before = [t.clone() for t in trees.tree_leaves(ttr.ref_params)]
    jsum, tsum = [], []
    for _ in range(ROUNDS):
        draws = _round_draws(jtr, jcfg)
        jsum.append(jtr.run_round())
        tsum.append(ttr.run_round(**draws))
    return jsum, tsum, ref_before, ttr


@pytest.mark.parametrize("r", range(ROUNDS),
                         ids=["round1", "round2_carried"])
def test_full_parameter_wan_rounds_match_jax(wan_rounds, r):
    jsum, tsum, _, ttr = wan_rounds
    got, want = tsum[r], jsum[r]
    assert list(got) == list(want)
    for key in ("comm_bytes", "up_bytes", "down_bytes", "participants",
                "dispatches", "up_nbytes", "down_nbytes", "local_steps",
                "cohorts"):
        assert got[key] == want[key], key
    d = ttr.d_trainable
    assert d == sum(t.numel() for t in trees.tree_leaves(ttr.params))
    assert got["comm_bytes"] == (r + 1) * C * (
        make_codec("int8+ef").nbytes_static(d)
        + make_codec("identity").nbytes_static(d))
    np.testing.assert_array_equal(got["rewards_per_client"],
                                  want["rewards_per_client"])
    np.testing.assert_array_equal(got["rewards"], want["rewards"])
    for key in ("lam_mean", "per_client_lam", "lam_disagreement"):
        assert_close(got[key], want[key], TOL, key)
    assert_of_scale(got["param_drift"], want["param_drift"], TOL, "drift")
    assert got["param_drift"] > 0
    assert abs(got["kl"] - want["kl"]) <= KL_ATOL, (got["kl"], want["kl"])
    if r == 1:
        assert abs(got["kl"]) > 10 * KL_ATOL


def test_reference_params_unchanged_after_the_rounds(wan_rounds):
    """Every parameter is trainable, yet the frozen reference is the
    trainer's own copy, and after two rounds it holds its initial bits
    while the global model moved."""
    _, _, ref_before, ttr = wan_rounds
    ref_after = trees.tree_leaves(ttr.ref_params)
    assert all(a is not b for a, b in zip(
        ref_after, trees.tree_leaves(ttr.global_trainable)))
    assert all(torch.equal(a, b) for a, b in zip(ref_after, ref_before))
    assert any(not torch.equal(a, b) for a, b in zip(
        trees.tree_leaves(ttr.global_trainable), ref_before))


def test_launch_train_runs_xlstm_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    tr = train_cli.main(["--arch", ARCH, "--device", "cpu", "--rounds", "1",
                         "--clients", "2", "--local-steps", "1",
                         "--batch-size", "2", "--max-new", "4", "--layers",
                         "3", "--d-model", "64", "--vocab", "64", "--out",
                         str(tmp_path)])
    assert (tmp_path / "adapters.npz").exists()
    assert tr.d_trainable == sum(t.numel() for t in
                                 trees.tree_leaves(tr.params))
    assert "xlstm-125m-smoke" in capsys.readouterr().out
