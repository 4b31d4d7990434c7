"""The port's kernel modules against the JAX package, on the CPU.

The plain PyTorch ``rmsnorm`` and ``flash_attention`` of
``repro_torch.kernels`` are held against ``repro.kernels.ref`` and against
the Pallas kernels in interpret mode, on the same numpy inputs (the plain
``gram`` and the backward versions: ``tests/test_torch_training.py``).
The CUDA kernels themselves run only on the card (``chip_smoke.py``);
here the dispatch, the wrappers' refusal of CPU tensors and the C
signatures are checked.

Tolerances: f32 1e-5 (rmsnorm) and 2e-4 (attention, the Pallas tests'
own); bf16 at most 1 bf16 ulp for rmsnorm (only the f32 reduction order
differs) and 2e-2 for attention, where both sides round an f32 result to
bf16 once.
"""
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import gram as gram_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_mod  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative to the value


def _pair(x: np.ndarray, dt: str):
    """The same f32 numpy array as a JAX and a torch array of dtype dt."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _attn_inputs(seed, b, sq, skv, hq, hkv, dh, dt):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, dh), dtype=np.float32)
    k = rng.standard_normal((b, skv, hkv, dh), dtype=np.float32)
    v = rng.standard_normal((b, skv, hkv, dh), dtype=np.float32)
    return _pair(q, dt), _pair(k, dt), _pair(v, dt)


# ---------------------------------------------------------------- rmsnorm
def _rms_tol(dt):
    return dict(rtol=1e-5, atol=1e-5) if dt == "f32" else \
        dict(rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("shape", [(7, 64), (2, 33, 256), (1, 1, 8),
                                   (3, 2048)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rmsnorm_plain_matches_jax_ref_and_pallas(shape, dt):
    rng = np.random.default_rng(sum(shape))
    (jx, tx) = _pair(rng.standard_normal(shape, dtype=np.float32), dt)
    (jg, tg) = _pair(rng.standard_normal(shape[-1:], dtype=np.float32), dt)
    got = _np(ref.rmsnorm(tx, tg))
    assert ref.rmsnorm(tx, tg).dtype == tx.dtype
    np.testing.assert_allclose(got, _np(jref.rmsnorm(jx, jg)), **_rms_tol(dt))
    np.testing.assert_allclose(
        got, _np(pallas_rmsnorm(jx, jg, interpret=True, block_rows=4)),
        **_rms_tol(dt))


def test_rmsnorm_rounds_before_scaling():
    """bf16: the normalised row is rounded to bf16 before the scale by g."""
    x = torch.tensor([[1.0, 3.0, -2.0, 0.5]]).to(torch.bfloat16)
    g = torch.tensor([1.7, 0.3, 2.9, -1.1]).to(torch.bfloat16)
    xf = x.float()
    normed = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5))
    want = (normed.to(torch.bfloat16).float() * g.float()).to(torch.bfloat16)
    assert torch.equal(ref.rmsnorm(x, g), want)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_matches_jax_ref_and_pallas(hq, hkv, causal, dt):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(hq * 10 + hkv, 2, 64, 64,
                                                hq, hkv, 32, dt)
    got = ref.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dt == "bf16" else 2e-4
    np.testing.assert_allclose(
        _np(got), _np(jref.flash_attention(jq, jk, jv, causal=causal)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(got), _np(pallas_flash(jq, jk, jv, causal=causal, block_q=32,
                                   block_k=32, interpret=True)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [8, 16, 40])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_sliding_window(window, dt):
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(window, 1, 64, 64, 4, 2, 16,
                                                dt)
    got = _np(ref.flash_attention(tq, tk, tv, causal=True,
                                  sliding_window=window))
    tol = 2e-2 if dt == "bf16" else 2e-4
    np.testing.assert_allclose(
        got, _np(jref.flash_attention(jq, jk, jv, causal=True,
                                      sliding_window=window)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got, _np(pallas_flash(jq, jk, jv, causal=True, sliding_window=window,
                              block_q=16, block_k=16, interpret=True)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_ragged_s12(causal, window, dt):
    """S = 12 (the tests' rollout length): the Pallas kernel asserts
    divisibility, so only the JAX oracle is compared."""
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(12, 2, 12, 12, 4, 2, 16, dt)
    got = ref.flash_attention(tq, tk, tv, causal=causal,
                              sliding_window=window)
    want = jref.flash_attention(jq, jk, jv, causal=causal,
                                sliding_window=window)
    tol = 2e-2 if dt == "bf16" else 2e-4
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# --------------------------------------------------------------- dispatch
def test_ops_send_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 16), dtype=np.float32))
    g = torch.ones(16)
    (_, q), (_, k), (_, v) = _attn_inputs(1, 1, 8, 8, 2, 1, 16, "f32")
    counts = (lambda: (rn_mod.launches, rn_mod.bwd_launches, fa_mod.launches,
                       fa_mod.bwd_launches, gram_mod.launches))
    before = counts()
    for use_kernel in (True, False):
        assert torch.equal(ops.rmsnorm(x, g, use_kernel=use_kernel),
                           ref.rmsnorm(x, g))
        assert torch.equal(
            ops.flash_attention(q, k, v, causal=True, use_kernel=use_kernel),
            ref.flash_attention(q, k, v, causal=True))
        assert torch.equal(ops.gram(x[:2], use_kernel=use_kernel),
                           ref.gram(x[:2]))
        # on the CPU, autograd differentiates the plain versions
        xg = x.clone().requires_grad_()
        ops.rmsnorm(xg, g, use_kernel=use_kernel).sum().backward()
        # (f32 sums in another order: 1e-6)
        assert torch.allclose(
            xg.grad, ref.rmsnorm_bwd(x, g, torch.ones_like(x)), atol=1e-6)
        qg = q.clone().requires_grad_()
        ops.flash_attention(qg, k, v, use_kernel=use_kernel).sum().backward()
        assert torch.allclose(qg.grad, ref.flash_attention_bwd(
            q, k, v, torch.ones_like(q))[0], atol=1e-6)
    assert counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.ones(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rn_mod.rmsnorm(x, torch.ones(16))
    with pytest.raises(ValueError, match="CUDA"):
        rn_mod.rmsnorm_bwd(x, torch.ones(16), x)
    q = torch.ones(1, 4, 2, 16)
    kv = q[:, :, :1].contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention_bwd(q, kv, kv, q, torch.zeros(1, 2, 4), q)
    with pytest.raises(ValueError, match="CUDA"):
        gram_mod.gram(x)


def _c_signatures():
    """extern "C" entry points of csrc/*.cu -> their parameter lists."""
    found = {}
    for src in build.sources():
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = [p.strip() for p in params.split(",")]
    return found


def test_ctypes_signatures_match_the_c_sources():
    """The argtypes handed to ctypes agree with the C declarations, so no
    pointer is passed as a 32-bit int and no float as an int."""
    import ctypes
    c_sigs = _c_signatures()
    assert set(c_sigs) == set(build.SIGNATURES)
    kinds = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    for name, argtypes in build.SIGNATURES.items():
        params = c_sigs[name]
        assert len(params) == len(argtypes), name
        for param, at in zip(params, argtypes):
            want = kinds[at]
            if want == "void*":
                assert "*" in param, (name, param)
            else:
                assert param.split()[0] == want and "*" not in param, \
                    (name, param)


def test_library_path_keys_on_sources(tmp_path, monkeypatch):
    """An edited source gives a new library name; the build lives under
    build/ at the repository root."""
    first = build.library_path()
    assert first.parent == build.BUILD_DIR and first.suffix == ".so"
    assert build.library_path() == first
    for src in build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path() == first
    edited = tmp_path / build.sources()[0].name
    edited.write_text(edited.read_text() + "\n// edited\n")
    assert build.library_path() != first
