"""The port's codec layer (``repro_torch.comms``) and the plain versions of
its four kernels against the JAX package, on the CPU.

Exact, compared as uint32 patterns: given the same rounding bits, the
quantize codes and scales, the dequantized values and the error-feedback
residuals; the threshold count and mask; the top-k bisection's (lo, hi),
support and values, and the top-k error-feedback residuals; the delta
codec's reconstructions.  The bits are drawn with numpy or by
``jax.random.bits`` and handed to both sides, the port's as int32 tensors
holding the same patterns.  The low-rank codec is held to 1e-5 of its
output's scale, given the same omega (JAX's draw, injected): its products
and QR sum in other orders (the two sides differ by ~1e-6 here; the
reference's own jitted and eager decodes are not bit-identical either).
The reference's Pallas kernels run in interpret mode, as its own tests run
them here.
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
from repro.comms import sparsify as jsparsify  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quantize as jq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.comms import codec, make_codec  # noqa: E402
from repro_torch.comms import lowrank as tlowrank  # noqa: E402
from repro_torch.comms import quantize as tquantize  # noqa: E402
from repro_torch.comms import sparsify as tsparsify  # noqa: E402
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
                                  "int4+ef", "topk:0.05", "topk:0.05+ef",
                                  "lowrank:4", "lowrank:4+ef", "delta+int8",
                                  "delta+int8+ef"])
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


def _structure(cd):
    """A codec's wrappers and leaf, as (class name, name, parameters)."""
    out = []
    while cd is not None:
        out.append((type(cd).__name__, cd.name,
                    getattr(cd, "stochastic", None), getattr(cd, "frac", None),
                    getattr(cd, "rank", None),
                    getattr(cd, "power_iters", None)))
        cd = getattr(cd, "inner", None)
    return out


@pytest.mark.parametrize("spec", ["identity", "int8", "int8:det", "int4",
                                  "int4:det", "int8+ef", "int4+ef",
                                  "int4:det+ef", " int8+ef ", "topk:0.05",
                                  "topk:0.05+ef", "lowrank:4", "lowrank+ef",
                                  "delta+int8", "delta"])
def test_registry_accepts_the_ported_specs(spec):
    assert _structure(make_codec(spec)) == _structure(jmake_codec(spec))
    assert make_codec("").name == "identity"


def test_registry_has_every_preset_and_spec_of_the_reference():
    from repro.comms import registry as jregistry
    from repro.configs.base import CODEC_PRESETS as JPRESETS
    from repro_torch.comms import registry
    from repro_torch.configs.base import CODEC_PRESETS
    assert CODEC_PRESETS == JPRESETS
    assert registry.available() == jregistry.available()
    for up, down in CODEC_PRESETS.values():
        for spec in (up, down, "delta+" + up):
            assert _structure(make_codec(spec)) == \
                _structure(jmake_codec(spec)), spec
    assert make_codec("topk").frac == 0.05
    assert make_codec("lowrank:8+ef").inner.rank == 8


@pytest.mark.parametrize("spec,match", [
    ("identity+ef", "lossless"), ("bogus", "unknown codec")])
def test_registry_refuses_what_is_not_ported(spec, match):
    with pytest.raises(ValueError, match=match):
        make_codec(spec)


# ------------------------------------------ the top-k threshold passes
def _threshold_blocks(rows: int, seed: int) -> np.ndarray:
    """(rows, 1024) f32 of mixed scales with an all-zero row, -0.0 entries
    and a run of entries tied at 0.5 (either sign)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, 1024))
         * rng.uniform(1e-3, 2, (rows, 1))).astype(np.float32)
    x[1] = 0.0
    x[2, ::5] = -0.0
    x[3, :300:3] = 0.5
    x[3, 1:300:3] = -0.5
    return x


def _thresholds(x: np.ndarray):
    a = np.abs(x)
    return {"zero": np.float32(0.0), "negative": np.float32(-1.0),
            "mid": np.float32(np.median(a)), "tie": np.float32(0.5),
            "above max": np.nextafter(a.max(), np.float32(np.inf))}


@pytest.mark.parametrize("thresh", ["zero", "negative", "mid", "tie",
                                    "above max"])
@pytest.mark.parametrize("rows", [4, 300])
def test_threshold_count_and_mask_plain_match_pallas_interpret(rows, thresh):
    """Exact at 4 rows and at 300 (across the reference's 256-row tile,
    whose zero padding it subtracts again when t <= 0); -0.0 kept as -0.0
    when t <= 0, a dropped entry +0.0.  The stacked form (C clients, one
    threshold each) gives each client's own count and mask."""
    x = _threshold_blocks(rows, seed=rows)
    t = _thresholds(x)[thresh]
    want_n = jq.abs_threshold_count(jnp.asarray(x), jnp.asarray(t),
                                    interpret=True)
    want_m = jq.abs_threshold_mask(jnp.asarray(x), jnp.asarray(t),
                                   interpret=True)
    got_n = ref.abs_threshold_count(_t(x), float(t))
    got_m = ref.abs_threshold_mask(_t(x), float(t))
    assert got_n.dtype == torch.float32 and got_n.shape == ()
    assert_same_bits(got_n.reshape(1), np.asarray(want_n).reshape(1),
                     "count")
    assert_same_bits(got_m, want_m, "mask")
    assert float(got_n) == float((np.abs(x) >= t).sum())
    if t <= 0:
        assert (_u32(got_m[2, ::5]) == 0x80000000).all()      # -0.0 kept
    # C = 3: this block, its negation, and a scaled copy, each with its
    # own threshold
    xs = np.stack([x, -x, 3 * x])
    ts = np.array([t, t, 3 * t], np.float32)
    n3 = ops.abs_threshold_count(_t(xs), _t(ts))
    m3 = ops.abs_threshold_mask(_t(xs), _t(ts))
    for c in range(3):
        assert_same_bits(n3[c].reshape(1), np.asarray(
            jq.abs_threshold_count(jnp.asarray(xs[c]), jnp.asarray(ts[c]),
                                   interpret=True)).reshape(1), f"count {c}")
        assert_same_bits(m3[c], jq.abs_threshold_mask(
            jnp.asarray(xs[c]), jnp.asarray(ts[c]), interpret=True),
            f"mask {c}")


def _topk_cases():
    """(flat, k) pairs: the reference's own cases and the edges."""
    rng = np.random.default_rng(0)
    ties = np.zeros(4096, np.float32)
    ties[:7], ties[20:40], ties[-1] = 0.5, 0.5, 5.0
    few = np.zeros(4096, np.float32)
    few[4092:] = [1.0, 2.0, 3.0, 4.0]
    normal = rng.standard_normal(5000).astype(np.float32)
    ragged = rng.standard_normal(2 * 1024 + 77).astype(np.float32)
    ragged[::9] = 0.25
    return {"ties": (ties, 8), "fewer nonzeros than k": (few, 16),
            "all zeros": (np.zeros(3000, np.float32), 5),
            "ragged d": (ragged, 300), "k = 1": (normal, 1),
            "k = d": (ragged, ragged.size), "k = 250": (normal, 250)}


@pytest.mark.parametrize("case", list(_topk_cases()))
def test_topk_threshold_and_support_match_jax_bit_for_bit(case):
    """(lo, hi) from the bisection, then the support and its values, as
    the reference's Pallas path gives them; and the stacked form (the
    case and its negation, one bracket each) gives each row's own."""
    flat, k = _topk_cases()[case]
    jlo, jhi = jops.topk_threshold(jquantize._to_blocks(jnp.asarray(flat)),
                                   k)
    lo, hi = ops.topk_threshold(tquantize._to_blocks(_t(flat)), k)
    assert lo.dtype == hi.dtype == torch.float32
    assert_same_bits(torch.stack([lo, hi]), np.stack([jlo, jhi]),
                     "(lo, hi)")
    jidx, jvals = jsparsify.topk_support(jnp.asarray(flat), k)
    idx, vals = tsparsify.topk_support(_t(flat), k)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert_same_bits(vals, jvals, "values")
    flats = _t(np.stack([flat, -flat]))
    x, rows = tquantize._stacked_blocks(flats)
    lo2, hi2 = ops.topk_threshold(x.view(2, rows, 1024), k)
    assert_same_bits(lo2, torch.stack([lo, lo]), "stacked lo")
    assert_same_bits(hi2, torch.stack([hi, hi]), "stacked hi")
    idx2, vals2 = tsparsify.topk_support_stacked(flats, k)
    assert torch.equal(idx2, torch.stack([idx, idx]))
    assert_same_bits(vals2, torch.stack([vals, -vals]), "stacked values")


def test_topk_support_without_kernel_matches_lax_top_k():
    flat = np.random.default_rng(1).standard_normal(5000).astype(np.float32)
    for k in (1, 250):
        jidx, jvals = jsparsify.topk_support(jnp.asarray(flat), k,
                                             use_pallas=False)
        idx, vals = tsparsify.topk_support(_t(flat), k, use_kernel=False)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert_same_bits(vals, jvals, "values")
        assert torch.equal(idx, tsparsify.topk_support(_t(flat), k)[0])


@pytest.mark.parametrize("spec", ["topk:0.05+ef", "topk:0.05"])
def test_topk_roundtrip_stacked_matches_jax_residuals_included(spec):
    """Two rounds of the stacked top-k uplink, the residual carried: the
    indices, values, decoded rows and residuals are the reference's bits
    (its error-feedback path is one jitted, vmapped encode over the
    clients; the residual adj - decoded is exact)."""
    c, d = 2, D_PAD
    jc, tc = jmake_codec(spec), make_codec(spec)
    jspec, tspec = _spec(d)
    flats, states, _, _ = _stacked_case(c, d, seed=4)
    ef = spec.endswith("+ef")
    jstates = [jnp.asarray(s) for s in states] if ef else None
    tstates = [_t(s) for s in states] if ef else None
    for rnd in range(2):
        flats_r = flats * (rnd + 1)
        _, _, keys, _ = _stacked_case(c, d, seed=20 + rnd)
        jp, jstates, jdec = jc.roundtrip_stacked(
            jnp.asarray(flats_r), jspec, jstates, keys=keys)
        tp, tstates, tdec = tc.roundtrip_stacked(_t(flats_r), tspec, tstates)
        assert_same_bits(tdec, jdec, f"round {rnd} decoded")
        for i in range(c):
            assert tp[i].kind == jp[i].kind == "topk:0.05"
            assert tp[i].meta["k"] == jp[i].meta["k"] == round(0.05 * d)
            assert tp[i].nbytes == jp[i].nbytes == tc.nbytes_static(d)
            np.testing.assert_array_equal(
                tp[i].arrays["indices"].numpy(),
                np.asarray(jp[i].arrays["indices"]))
            assert_same_bits(tp[i].arrays["values"], jp[i].arrays["values"],
                             "values")
            if ef:
                assert_same_bits(tstates[i], jstates[i],
                                 f"round {rnd} residual {i}")
            else:
                assert tstates[i] is None and jstates[i] is None
        # the decoded rows are what a receiver decodes from the payloads
        for i in range(c):
            assert torch.equal(tc.decode_flat(tp[i]), tdec[i])


def test_ef_wraps_any_inner_codec():
    """Error feedback around top-k and low-rank: the residual is adj -
    decoded, and the next round adds it back.  (The wrapper once called
    the quantize codec's private methods on any inner codec and raised
    AttributeError for these.)"""
    from repro_torch.comms.codec import ErrorFeedback
    from repro_torch.comms.lowrank import LowRankCodec
    from repro_torch.comms.sparsify import TopKCodec
    d = D_PAD
    _, tspec = _spec(d)
    flats, states, _, _ = _stacked_case(2, d, seed=6)
    for inner in (TopKCodec(0.1), LowRankCodec(2)):
        ef = ErrorFeedback(inner)
        assert ef.name == inner.name + "+ef"
        adj = _t(flats) + torch.stack([_t(s) for s in states])
        _, res, dec = ef.roundtrip_stacked(_t(flats), tspec,
                                           [_t(s) for s in states])
        _, _, dec_inner = inner.roundtrip_stacked(adj, tspec)
        assert torch.equal(dec, dec_inner)
        assert torch.equal(torch.stack(res), adj - dec)
        p, r1, dec1 = ef.roundtrip_flat(_t(flats[0]), tspec, res[0])
        assert torch.equal(r1, _t(flats[0]) + res[0] - dec1)
        assert p.nbytes == inner.nbytes_static(d)


@pytest.mark.parametrize("spec", ["lowrank:4", "lowrank:4+ef"])
def test_lowrank_matches_jax_with_injected_omega(spec):
    """Two rounds with JAX's omega draws injected: decoded rows, q @ b and
    residuals within 1e-5 of their scale (see the module docstring); q
    within 1e-5 up to each column's sign."""
    c, d, r = 2, D_PAD, 4
    a, b = tlowrank._matrix_shape(d)
    jc, tc = jmake_codec(spec), make_codec(spec)
    jspec, tspec = _spec(d)
    flats, states, _, _ = _stacked_case(c, d, seed=8)
    ef = spec.endswith("+ef")
    jstates = [jnp.asarray(s) for s in states] if ef else None
    tstates = [_t(s) for s in states] if ef else None

    def close(got, want, what):
        g, w = _u32(got).view(np.float32), np.asarray(want, np.float32)
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (what, err)
    for rnd in range(2):
        keys = list(jax.random.split(jax.random.PRNGKey(30 + rnd), c))
        omega = np.stack([np.asarray(jax.random.normal(k, (b, r),
                                                       jnp.float32))
                          for k in keys])
        jp, jstates, jdec = jc.roundtrip_stacked(
            jnp.asarray(flats), jspec, jstates, keys=keys)
        tp, tstates, tdec = tc.roundtrip_stacked(
            _t(flats), tspec, tstates, bits=_t(omega))
        close(tdec, jdec, f"round {rnd} decoded")
        for i in range(c):
            q, jq_ = tp[i].arrays["q"].numpy(), np.asarray(jp[i].arrays["q"])
            assert q.shape == (a, r) and tp[i].arrays["b"].shape == (r, b)
            sign = np.sign((q * jq_).sum(0))
            close(q * sign, jq_, "q")
            close(tp[i].arrays["b"].numpy() * sign[:, None],
                  jp[i].arrays["b"], "b")
            assert tp[i].nbytes == jp[i].nbytes == 4 * r * (a + b)
            assert tp[i].meta["a"] == a and tp[i].meta["b_cols"] == b
            if ef:
                close(tstates[i], jstates[i], f"round {rnd} residual {i}")
        flats = flats * 1.5


@pytest.mark.parametrize("spec", ["delta+int8", "delta+int8+ef"])
def test_delta_codec_matches_jax_over_three_rounds(spec):
    """The downlink's delta chain through the tree API: the first
    transmission carries the parameters, later ones the change against
    the reconstruction.  Codes, scales, reconstructions and the states
    (reference and error-feedback residual) are the reference's bits:
    the subtraction and the addition around the inner codec round once
    each on both sides, and the inner codec is bit-identical."""
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal((3, 700)).astype(np.float32),
            "b": rng.standard_normal(77).astype(np.float32)}
    jc, tc = jmake_codec(spec), make_codec(spec)
    jstate = tstate = None
    for rnd in range(3):
        key = jax.random.PRNGKey(40 + rnd)
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        rows = -(-jcodec.tree_to_flat(jtree)[0].size // 1024)
        bits = np.asarray(jax.random.bits(key, (rows, 1024), jnp.uint32))
        jp, jstate, jdec = jc.roundtrip(jtree, jstate, key=key)
        tp, tstate, tdec = tc.roundtrip(bridge.to_torch(tree, device="cpu"),
                                        tstate, bits=_bits_t(bits))
        assert tp.kind == jp.kind and tp.nbytes == jp.nbytes
        np.testing.assert_array_equal(tp.arrays["codes"].numpy(),
                                      np.asarray(jp.arrays["codes"]))
        assert_same_bits(tp.arrays["scales"], jp.arrays["scales"], "scales")
        assert_same_bits(codec.tree_to_flat(tdec)[0],
                         jcodec.tree_to_flat(jdec)[0], f"round {rnd}")
        assert_same_bits(tstate[0], jstate[0], "reference")
        if spec.endswith("+ef"):
            assert_same_bits(tstate[1], jstate[1], "residual")
        else:
            assert tstate[1] is None and jstate[1] is None
        tree = jax.tree_util.tree_map(
            lambda a: a + (rng.standard_normal(a.shape) * 1e-3).astype(
                np.float32), tree)
    with pytest.raises(NotImplementedError, match="reference"):
        tc.decode(tp)
