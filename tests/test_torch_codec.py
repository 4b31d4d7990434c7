"""The port's codec layer (``repro_torch.comms``) and the plain versions of
its two kernels against the JAX package, on the CPU.

Everything here is exact: given the same rounding bits, the quantize codes
and scales, the dequantized values and the error-feedback residuals are
the reference's bit for bit (compared as uint32 patterns).  The bits are
drawn with numpy or by ``jax.random.bits`` and handed to both sides, the
port's as int32 tensors holding the same patterns.  The reference's Pallas
kernels run in interpret mode, as its own tests run them here.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comms import codec as jcodec  # noqa: E402
from repro.comms import make_codec as jmake_codec  # noqa: E402
from repro.comms import quantize as jquantize  # noqa: E402
from repro.kernels import quantize as jq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.comms import codec, make_codec  # noqa: E402
from repro_torch.comms import quantize as tquantize  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

D_PAD = 5 * 1024 + 77          # a width that needs padding to whole rows


def _u32(a) -> np.ndarray:
    """Bit patterns of a 4-byte array (tensor or array) as uint32."""
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def assert_same_bits(got, want, what=""):
    g, w = _u32(got), _u32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bad = int((g != w).sum())
    assert bad == 0, f"{what}: {bad} of {g.size} entries differ"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits_t(bits: np.ndarray) -> torch.Tensor:
    """uint32 offsets -> the port's int32 tensor of the same patterns."""
    return torch.from_numpy(np.array(bits, dtype=np.uint32).view(np.int32))


def _blocks(rows: int, seed: int):
    """(rows, 1024) f32 of mixed scales with an all-zero row, and uint32
    bits with a round-to-nearest row and a row of the largest offsets
    (2**32 - 1 and 2**32 - 128 both convert to r = 1.0)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, 1024))
         * rng.uniform(1e-5, 10, (rows, 1))).astype(np.float32)
    x[1] = 0.0
    bits = rng.integers(0, 2 ** 32, (rows, 1024), dtype=np.uint64
                        ).astype(np.uint32)
    bits[2] = 2 ** 31
    bits[3] = 2 ** 32 - 1
    bits[3, ::3] = 2 ** 32 - 128
    return x, bits


# ------------------------------------------------ the kernels' plain versions
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("rows", [4, 300])
def test_quantize_plain_matches_pallas_interpret(qmax, rows):
    x, bits = _blocks(rows, seed=qmax + rows)
    want_c, want_s = jq.quantize(jnp.asarray(x), jnp.asarray(bits),
                                 qmax=qmax, interpret=True)
    got_c, got_s = ref.quantize(_t(x), _bits_t(bits), qmax)
    assert got_c.dtype == torch.int8 and got_s.shape == (rows, 1)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert_same_bits(got_s, want_s, "scales")
    assert float(got_s[1, 0]) == 1.0                  # the all-zero row
    assert int(got_c.abs().max()) <= qmax
    # the dispatch sends CPU tensors to the plain version
    c2, s2 = ops.quantize(_t(x), _bits_t(bits), qmax)
    assert torch.equal(c2, got_c) and torch.equal(s2, got_s)


def test_quantize_scale_is_the_compiled_reciprocal_multiply():
    """XLA compiles the reference's absmax / qmax as absmax * rn(1/qmax);
    rows where that differs from the division exist, and the plain version
    takes the reference's side."""
    x, bits = _blocks(600, seed=11)
    absmax = np.abs(x).max(1, keepdims=True)
    div = absmax / np.float32(127)
    assert (div != absmax * (np.float32(1) / np.float32(127))).any()
    _, want_s = jq.quantize(jnp.asarray(x), jnp.asarray(bits), qmax=127,
                            interpret=True)
    _, got_s = ref.quantize(_t(x), _bits_t(bits), 127)
    assert_same_bits(got_s, want_s, "scales")


@pytest.mark.parametrize("qmax", [127, 7])
def test_dequantize_plain_matches_pallas_interpret(qmax):
    x, bits = _blocks(40, seed=qmax)
    codes, scales = jq.quantize(jnp.asarray(x), jnp.asarray(bits),
                                qmax=qmax, interpret=True)
    want = jq.dequantize(codes, scales, interpret=True)
    got = ref.dequantize(_t(codes), _t(scales))
    assert_same_bits(got, want, "decoded")
    assert torch.equal(ops.dequantize(_t(codes), _t(scales)), got)
    dec, res = ops.dequantize_with_residual(_t(codes), _t(scales), _t(x))
    assert torch.equal(dec, got)
    assert torch.equal(res, ref.dequantize_residual(_t(codes), _t(scales),
                                                    _t(x)))


# --------------------------------------------------------------- the codecs
def _spec(d):
    return jcodec.tree_to_flat({"a": jnp.zeros(d, jnp.float32)})[1], \
        codec.tree_to_flat({"a": torch.zeros(d)})[1]


def _stacked_case(c, d, seed):
    rng = np.random.default_rng(seed)
    flats = (rng.standard_normal((c, d)) * 1e-3).astype(np.float32)
    states = [(rng.standard_normal(d) * 1e-5).astype(np.float32)
              for _ in range(c)]
    keys = list(jax.random.split(jax.random.PRNGKey(seed), c))
    rows = -(-d // 1024)
    bits = np.stack([np.asarray(jax.random.bits(k, (rows, 1024),
                                                jnp.uint32)) for k in keys])
    return flats, states, keys, bits


@pytest.mark.parametrize("spec", ["int8+ef", "int4+ef"])
def test_ef_roundtrip_stacked_matches_jax_residuals_included(spec):
    """Two rounds of the stacked error-feedback uplink, the residual
    carried: codes, scales, decoded values and residuals are the
    reference's bits.  The residual of the reference is adj - codes*scale
    rounded once (XLA's fused multiply-subtract); the two-rounding form
    adj - decoded differs from it in many entries."""
    c, d = 2, D_PAD
    jc, tc = jmake_codec(spec), make_codec(spec)
    jspec, tspec = _spec(d)
    flats, states, _, _ = _stacked_case(c, d, seed=1)
    jstates = [jnp.asarray(s) for s in states]
    tstates = [_t(s) for s in states]
    for rnd in range(2):
        flats_r = flats * (rnd + 1)
        _, _, keys, bits = _stacked_case(c, d, seed=10 + rnd)
        jp, jstates, jdec = jc.roundtrip_stacked(
            jnp.asarray(flats_r), jspec, jstates, keys=keys)
        tp, tstates, tdec = tc.roundtrip_stacked(
            _t(flats_r), tspec, tstates, bits=_bits_t(bits))
        assert_same_bits(tdec, jdec, f"round {rnd} decoded")
        for i in range(c):
            np.testing.assert_array_equal(tp[i].arrays["codes"].numpy(),
                                          np.asarray(jp[i].arrays["codes"]))
            assert_same_bits(tp[i].arrays["scales"], jp[i].arrays["scales"],
                             "scales")
            assert tp[i].nbytes == jp[i].nbytes
            assert tp[i].kind == jp[i].kind
            assert_same_bits(tstates[i], jstates[i],
                             f"round {rnd} residual {i}")
        adj = _t(flats_r) + torch.stack(
            [_t(np.asarray(s)) for s in (states if rnd == 0 else prev)])
        naive = (adj - tdec).numpy()
        assert (_u32(naive) != _u32(np.stack(
            [np.asarray(s) for s in jstates]))).sum() > d // 10
        prev = [np.asarray(s) for s in jstates]


@pytest.mark.parametrize("spec", ["int8", "int4", "int8:det"])
def test_quantize_codec_stacked_matches_jax(spec):
    """No error feedback; client 1 has no key, so it rounds to nearest
    (the reference's per-row fallback), as does every row of ':det'."""
    c, d = 2, D_PAD
    jcd, tcd = jmake_codec(spec), make_codec(spec)
    jspec, tspec = _spec(d)
    flats, _, keys, bits = _stacked_case(c, d, seed=3)
    gen = torch.Generator().manual_seed(0)
    jp, _, jdec = jcd.roundtrip_stacked(jnp.asarray(flats), jspec,
                                        keys=[keys[0], None])
    # client 0's bits injected through its generator's place: the codec
    # takes bits for every row or a generator per row
    tp, _, tdec = tcd.roundtrip_stacked(
        _t(flats), tspec, bits=torch.stack(
            [_bits_t(bits[0]), torch.full(bits[1].shape, -2 ** 31,
                                          dtype=torch.int32)]))
    assert_same_bits(tdec, jdec, "decoded")
    for i in range(c):
        np.testing.assert_array_equal(tp[i].arrays["codes"].numpy(),
                                      np.asarray(jp[i].arrays["codes"]))
    # a generator key (not injected) draws its own bits; a None key rounds
    # to nearest whatever the codec's stochasticity
    tp2, _, _ = tcd.roundtrip_stacked(_t(flats), tspec, keys=[gen, None])
    det, _ = tcd.encode_flat(_t(flats[1]))
    np.testing.assert_array_equal(tp2[1].arrays["codes"].numpy(),
                                  det["codes"].numpy())
    np.testing.assert_array_equal(tp2[1].arrays["codes"].numpy(),
                                  np.asarray(jp[1].arrays["codes"]))
    # encode_stacked gives the roundtrip's payloads
    ep, _ = tcd.encode_stacked(_t(flats), tspec, bits=torch.stack(
        [_bits_t(bits[0]), torch.full(bits[1].shape, -2 ** 31,
                                      dtype=torch.int32)]))
    for a, b in zip(ep, tp):
        assert torch.equal(a.arrays["codes"], b.arrays["codes"])


@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_downlink_tree_roundtrip_matches_jax(spec):
    """The tree API, as the downlink runs it (the ``mobile`` preset's int8
    broadcast): a tree with None slots, flattened in sorted-key order."""
    rng = np.random.default_rng(5)
    tree = {"wq": {"lora_B": rng.standard_normal((3, 700)).astype(np.float32),
                   "lora_A": rng.standard_normal((3, 16)).astype(np.float32),
                   "w": None},
            "embed": None,
            "b": rng.standard_normal(5).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jflat, _ = jcodec.tree_to_flat(jtree)
    rows = -(-jflat.size // 1024)
    bits = np.asarray(jax.random.bits(key, (rows, 1024), jnp.uint32))
    jp, _, jdec = jmake_codec(spec).roundtrip(jtree, None, key=key)
    ttree = bridge.to_torch(tree, device="cpu")
    tp, st, tdec = make_codec(spec).roundtrip(ttree, None, bits=_bits_t(bits))
    assert st is None and tp.nbytes == jp.nbytes
    np.testing.assert_array_equal(tp.arrays["codes"].numpy(),
                                  np.asarray(jp.arrays["codes"]))
    got, want = codec.tree_to_flat(tdec)[0], jcodec.tree_to_flat(jdec)[0]
    assert_same_bits(got, want, "decoded tree")
    assert tdec["embed"] is None and tdec["wq"]["w"] is None
    assert tuple(tdec["wq"]["lora_B"].shape) == (3, 700)
    assert torch.equal(make_codec(spec).decode(tp)["b"], tdec["b"])


def test_identity_codec_and_flat_layout_match_jax():
    rng = np.random.default_rng(2)
    tree = {"z": rng.standard_normal((2, 3)).astype(np.float32),
            "a": {"y": rng.standard_normal(4).astype(np.float32), "n": None}}
    jflat, _ = jcodec.tree_to_flat(jax.tree_util.tree_map(jnp.asarray, tree))
    tflat, tspec = codec.tree_to_flat(bridge.to_torch(tree, device="cpu"))
    assert_same_bits(tflat, jflat, "flat")
    assert tspec.size == tflat.numel() == 10
    back = codec.flat_to_tree(tflat, tspec)
    assert back["a"]["n"] is None and torch.equal(back["z"], _t(tree["z"]))
    p, st, dec = make_codec("identity").roundtrip(
        bridge.to_torch(tree, device="cpu"), None)
    assert p.nbytes == 40 and st is None
    assert torch.equal(codec.tree_to_flat(dec)[0], tflat)


@pytest.mark.parametrize("spec", ["identity", "int8", "int4", "int8+ef",
                                  "int4+ef"])
@pytest.mark.parametrize("d", [1000, 1024, D_PAD])
def test_nbytes_static_equals_payload_nbytes(spec, d):
    cd = make_codec(spec)
    _, tspec = _spec(d)
    flat = _t(np.random.default_rng(d).standard_normal(d).astype(np.float32))
    p, _, dec = cd.roundtrip_flat(flat, tspec)
    assert p.nbytes == cd.nbytes_static(d) == jmake_codec(spec).nbytes_static(d)
    assert cd.bits_per_param(d) == jmake_codec(spec).bits_per_param(d)
    assert cd.meta_static(d) == jmake_codec(spec).meta_static(d)
    assert dec.shape == (d,)
    ps, _, decs = cd.roundtrip_stacked(torch.stack([flat, -flat]), tspec)
    assert [q.nbytes for q in ps] == [cd.nbytes_static(d)] * 2
    assert decs.shape == (2, d)


def test_pack_int4_round_trips_and_matches_jax():
    rng = np.random.default_rng(0)
    codes = rng.integers(-7, 8, (3, 1024)).astype(np.int8)
    packed = tquantize.pack_int4(_t(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 512)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jquantize.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tquantize.unpack_int4(packed).numpy(),
                                  codes)


@pytest.mark.parametrize("spec", ["identity", "int8", "int8:det", "int4",
                                  "int4:det", "int8+ef", "int4+ef",
                                  "int4:det+ef", " int8+ef "])
def test_registry_accepts_the_ported_specs(spec):
    got, want = make_codec(spec), jmake_codec(spec)
    assert got.name == want.name
    if hasattr(want, "inner"):
        want = want.inner
        got = got.inner
    assert type(got).__name__ == type(want).__name__
    assert getattr(got, "stochastic", None) == getattr(want, "stochastic",
                                                       None)
    assert make_codec("").name == "identity"


@pytest.mark.parametrize("spec,match", [
    ("topk:0.05", "not ported yet"), ("topk:0.05+ef", "not ported yet"),
    ("lowrank:4", "not ported yet"), ("lowrank+ef", "not ported yet"),
    ("delta+int8", "not ported yet"), ("delta", "not ported yet"),
    ("identity+ef", "lossless"), ("bogus", "unknown codec")])
def test_registry_refuses_what_is_not_ported(spec, match):
    with pytest.raises(ValueError, match=match):
        make_codec(spec)
