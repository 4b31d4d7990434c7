"""The port's sliding-window attention, ring cache and MoE block kinds
through the whole model, against the JAX package, on the CPU at a tiny
size.

Configs: ``mixtral-8x7b`` (``moe_swa``), ``moonshot-v1-16b-a3b``
(``moe``) and mixtral's pattern turned into ``swa`` (window, dense FFN),
each ``reduced(n_layers=2, d_model=64, vocab=128)`` on both sides (4
experts top-2, 4 heads of 16).  ``reduced()`` keeps a window of
min(128, window), longer than these sequences, so the window is set to 8:
it bites at S = 16, and ``prefill`` with a cache of 20 lays the window
slots out as a ring (C = 8 <= S), which the decode steps then wrap.  Both
sides get the same numpy inputs and the JAX model's parameters (non-zero
``lora_B``) carried over by ``repro_torch.bridge``.

Tolerances: f32 within 1e-5 of the compared tensor's scale (``|got -
want| <= 1e-5 * max(1, max|want|)``).  bf16 by the f32 rule of
``test_torch_hybrid.py``: the port's bf16 result as close to the f32
model's as the reference's bf16 result is (mean and root-mean-square
error within 25%), since a last-bit difference can flip a routing choice
or a rounding on either side.  Attention alone in bf16: 2e-2 of the scale,
``test_torch_models.py``'s rule.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, transformer as T  # noqa: E402

B, S, WINDOW, CACHE = 2, 16, 8, 20
TOL = 1e-5
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
MODELS = {"mixtral": ("mixtral-8x7b", None),
          "moonshot": ("moonshot-v1-16b-a3b", None),
          "swa": ("mixtral-8x7b", ("swa",))}


def _cfgs(model):
    arch, pattern = MODELS[model]
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(arch).reduced(n_layers=2, d_model=64, vocab=128)
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
        if pattern is not None:
            cfg = dataclasses.replace(cfg, pattern=pattern)
        out.append(cfg)
    return tuple(out)


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


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_close(got, want, tol=TOL, what=""):
    """|got - want| <= tol * max(1, max|want|), element for element."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max())
    assert err <= tol * max(1.0, float(np.abs(w).max())), (what, err)


def _tokens(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _x(seed, shape, dt):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [1, 5, 16])
def test_chunked_attention_with_a_window_matches_xla_twin(window, dt):
    jq, tq = _x(1, (B, 24, 4, 16), dt)
    jk, tk = _x(2, (B, 24, 2, 16), dt)
    jv, tv = _x(3, (B, 24, 2, 16), dt)
    got = attention.chunked_attention(tq, tk, tv, causal=True,
                                      sliding_window=window)
    want = jattn.chunked_attention(jq, jk, jv, causal=True,
                                   sliding_window=window, block=8)
    assert_close(got, want, TOL if dt == "f32" else 2e-2, f"window {window}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [3, 7, 15, 29])
def test_decode_attention_on_a_ring_matches_reference(pos, dt):
    """``test_models.py``'s ring case at several positions (before and
    after the ring wraps): the port's ring decode against the reference's
    with the same ring positions, and against the reference's full-cache
    decode with the window mask."""
    hq, hkv, dh, w = 4, 2, 8, 8
    rng = np.random.default_rng(pos)
    k_full, v_full = (rng.standard_normal((1, 32, hkv, dh), dtype=np.float32)
                      for _ in range(2))
    q = rng.standard_normal((1, 1, hq, dh), dtype=np.float32)
    ring_k, ring_v = np.zeros((1, w, hkv, dh), np.float32), \
        np.zeros((1, w, hkv, dh), np.float32)
    for p in range(pos + 1):
        ring_k[:, p % w], ring_v[:, p % w] = k_full[:, p], v_full[:, p]
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.tensor(pos, dtype=torch.int32)
    jcp = jT._ring_positions(jpos, w, w)
    tcp = T._ring_positions(tpos, w)
    np.testing.assert_array_equal(tcp.numpy(), np.asarray(jcp))
    cast = {n: (jnp.asarray(a).astype(JDT[dt]), torch.from_numpy(a).to(
        TDT[dt])) for n, a in (("q", q), ("k", ring_k), ("v", ring_v),
                               ("kf", k_full[:, :pos + 1]),
                               ("vf", v_full[:, :pos + 1]))}
    got = attention.decode_attention(cast["q"][1], cast["k"][1],
                                     cast["v"][1], tpos, sliding_window=w,
                                     cache_positions=tcp)
    want = jattn.decode_attention(cast["q"][0], cast["k"][0], cast["v"][0],
                                  jpos, sliding_window=w,
                                  cache_positions=jcp)
    full = jattn.decode_attention(cast["q"][0], cast["kf"][0],
                                  cast["vf"][0], jpos, sliding_window=w)
    assert got.dtype == TDT[dt]
    tol = TOL if dt == "f32" else 2e-2
    assert_close(got, want, tol, "ring")
    assert_close(got, full, tol, "full cache with the window mask")


# ---------------------------------------------------------- configs, tree
def _layout(tree, path=""):
    """{"['a']['b']": (shape, dtype name)} of a torch tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_layout(v, f"{path}['{k}']"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_reduced_config_and_tree_layout_match_reference(model):
    """The same keys, shapes and dtypes as the reference's tree: the MoE
    kinds' router f32 and experts stacked over periods, no ``mlp``, and
    adapters on the attention projections only."""
    jcfg, tcfg = _cfgs(model)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jtree = jT.init_params(jcfg, jax.random.PRNGKey(0))
    ttree = T.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert _layout(ttree) == want
    lora = [k for k in want if "lora" in k]
    assert lora and all("['attn']" in k for k in lora)
    if model != "swa":
        assert want["['slots']['0']['moe']['router']['w']"][1] == "float32"


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_prefill_and_four_decode_steps_f32(model):
    jcfg, tcfg = _cfgs(model)
    jp, tp = _params(jcfg, seed=1)
    tok = _tokens(2, (B, S + 5))
    want = jT.forward_seq(jcfg, jp, jnp.asarray(tok[:, :S]),
                          collect_kv=True)
    got = T.forward_seq(tcfg, tp, torch.from_numpy(tok[:, :S]),
                        collect_kv=True)
    assert_close(got["logits"], want["logits"], what="logits")
    assert_close(got["aux_loss"], want["aux_loss"], what="aux")
    if model != "swa":
        assert float(got["aux_loss"]) > 0
    for name in ("k", "v"):
        assert_close(got["kv"]["0"][name], want["kv"]["0"][name], what=name)

    jl, jcache = jT.prefill(jcfg, jp, jnp.asarray(tok[:, :S]),
                            cache_len=CACHE, cache_dtype=jnp.float32)
    tl, tcache = T.prefill(tcfg, tp, torch.from_numpy(tok[:, :S]),
                           cache_len=CACHE, cache_dtype=torch.float32)
    assert_close(tl, jl, what="prefill logits")
    c = WINDOW if model != "moonshot" else CACHE
    assert tcache["slots"]["0"]["k"].shape[2] == c
    for name in ("k", "v"):
        assert_close(tcache["slots"]["0"][name], jcache["slots"]["0"][name],
                     what=f"cache {name}")
    if c == WINDOW:
        # the ring: position p at slot p % C
        kv = got["kv"]["0"]["k"]
        for p in range(S - WINDOW, S):
            torch.testing.assert_close(tcache["slots"]["0"]["k"][:, :,
                                                                 p % c],
                                       kv[:, :, p], rtol=0, atol=0)
    for i in range(4):
        t = tok[:, S + i:S + i + 1]
        jlog, jcache = jT.decode_step(jcfg, jp, jcache, jnp.asarray(t))
        tlog, tcache = T.decode_step(tcfg, tp, tcache, torch.from_numpy(t))
        assert_close(tlog, jlog, what=f"decode step {i}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == S + 4


def _f32_rule(got, want, want32):
    """The port's bf16 errors against the f32 result within 25% of the
    reference's, on the mean and the root-mean-square."""
    e_got = np.abs(_np(got) - _np(want32)).ravel()
    e_ref = np.abs(_np(want) - _np(want32)).ravel()
    for stat, f in (("mean", np.mean),
                    ("rms", lambda e: np.sqrt(np.mean(np.square(e))))):
        g, r = float(f(e_got)), float(f(e_ref))
        assert g <= 1.25 * r, (stat, g, r)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_and_decode_in_bf16_by_the_f32_rule(model):
    """bf16 logits of the forward and of 4 decode steps after prefill
    (bf16 cache), pooled over three draws of parameters."""
    jcfg, tcfg = _cfgs(model)
    got, want, want32 = [], [], []
    for seed in range(3):
        jp, tp = _params(jcfg, "bf16", seed=10 + seed)
        jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        tok = _tokens(20 + seed, (B, S + 4))
        for side, params, out in (("j", jp, want), ("j32", jp32, want32),
                                  ("t", tp, got)):
            if side == "t":
                x = torch.from_numpy(tok)
                logits = [T.forward_seq(tcfg, params, x[:, :S])["logits"]]
                _, cache = T.prefill(tcfg, params, x[:, :S],
                                     cache_len=CACHE)
                for i in range(4):
                    step, cache = T.decode_step(tcfg, params, cache,
                                                x[:, S + i:S + i + 1])
                    logits.append(step[:, None])
            else:
                x = jnp.asarray(tok)
                logits = [jT.forward_seq(jcfg, params, x[:, :S])["logits"]]
                _, cache = jT.prefill(jcfg, params, x[:, :S],
                                      cache_len=CACHE)
                for i in range(4):
                    step, cache = jT.decode_step(jcfg, params, cache,
                                                 x[:, S + i:S + i + 1])
                    logits.append(step[:, None])
            out.append(np.concatenate([_np(a) for a in logits], 1))
    _f32_rule(np.stack(got), np.stack(want), np.stack(want32))
