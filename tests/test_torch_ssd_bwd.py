"""The SSD scan's backward: the plain formulas the Hopper backward kernel
implements (``kernels.ref.ssd_chunked_bwd``) against autograd of the plain
forward (``ref.ssd_chunked``), against ``jax.vjp`` of the reference's exact
recurrence (``repro.kernels.ref.ssd_scan``) and against a float64
recurrence; the backward kernel's source rules; and the ``SSDScan``
function's bookkeeping, on the CPU.

Inputs as the model makes them (``chip_smoke.py``'s ``ssd_inputs``): x, B
and C silu of one (B, S, nh hd + 2 ds) tensor, x, B and C strided views
into it, dt = softplus(N(0, 1)) and da = dt A with A = -(1..16) over the
heads, so that L falls to ~-1800 in a chunk of 128; dy and d(final state)
N(0, 1).

Tolerance: each of dx, dB, dC, d(dt) and d(da) within 1e-4 of its scale,
max |want|.  The scale of d(da) is at least max |dt d(dt)|: d(da) sums
terms (dS_ij S_ij, dw_j w_j) that d(dt) scaled by dt holds, and where they
cancel exactly (S = 1: the one position's L shifts every L of the chunk
alike, so its gradient is 0) the f32 sums leave a residue of their size.
The plain f32 autograd itself lies within 1e-4 of the float64 recurrence
on every case (checked below, so no f64 rule is needed): the plain
formulas are held to autograd, to JAX and to float64 directly.
"""
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
TOL = 1e-4
NAMES = ("dx", "dB", "dC", "d(dt)", "d(da)")

# (label, (B, S, nh, ds), chunk, zero-dt head, with d(final state))
CASES = [("ragged S=20 chunk 16", (2, 20, 2, 16), 16, None, True),
         ("S=40 chunk 16 (3 chunks)", (2, 40, 2, 16), 16, None, False),
         ("S=40 chunk 16 with the state", (2, 40, 3, 16), 16, None, True),
         ("zero-dt head S=40", (2, 40, 3, 16), 16, 1, True),
         ("ds 64 S=200 chunk 128", (1, 200, 2, 64), 128, None, True),
         ("ds 64 S=256 chunk 128", (2, 256, 2, 64), 128, None, False),
         ("S=1", (2, 1, 2, 16), 128, None, True),
         ("ds 64 S=129 chunk 128", (1, 129, 2, 64), 128, 0, True)]
IDS = [c[0] for c in CASES]


def _inputs(seed, b, s, nh, ds, zero=None, hd=64):
    """(x, B, C, dt, da) with x, B and C strided views, dy and d(final
    state), as float64 numpy arrays rounded from f32 draws."""
    rng = np.random.default_rng(seed)
    xbc = rng.standard_normal((b, s, nh * hd + 2 * ds)).astype(np.float32)
    xbc = xbc / (1 + np.exp(-xbc))                       # silu
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(
        np.float32)
    if zero is not None:
        dt[:, :, zero] = 0
    da = (dt * -np.linspace(1.0, 16.0, nh, dtype=np.float32)).astype(
        np.float32)
    dy = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dst = rng.standard_normal((b, nh, hd, ds)).astype(np.float32)
    return xbc, dt, da, dy, dst


def _views(xbc, dt, da, nh, ds, hd=64, requires_grad=False):
    t = torch.from_numpy(xbc.copy())
    b, s, _ = t.shape
    x = t[..., :nh * hd].view(b, s, nh, hd)
    bm, cm = t[..., nh * hd:nh * hd + ds], t[..., nh * hd + ds:]
    ins = [x, bm, cm, torch.from_numpy(dt), torch.from_numpy(da)]
    if requires_grad:
        ins = [v.detach().clone().requires_grad_() for v in ins]
    return ins


def _autograd(ins, dy, dst, chunk):
    ins = [v.detach().clone().requires_grad_() for v in ins]
    y, st = ref.ssd_chunked(*ins, chunk=chunk)
    outs, grads = ((y, st), (dy, dst)) if dst is not None else ((y,), (dy,))
    return torch.autograd.grad(outs, ins, grads)


def _recurrence64(ins, dy, dst):
    """Gradients of sum(y dy) + sum(h_S d(final state)) through the exact
    recurrence in float64, in the model's layout."""
    x, bm, cm, dt, da = (v.detach().double().requires_grad_() for v in ins)
    b, s, nh, hd = x.shape
    h = torch.zeros((b, nh, hd, bm.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(s):
        h = torch.exp(da[:, t])[:, :, None, None] * h + \
            (dt[:, t, :, None] * x[:, t])[..., None] * bm[:, t, None, None, :]
        ys.append(torch.einsum("bhds,bs->bhd", h, cm[:, t]))
    loss = (torch.stack(ys, 1) * dy.double()).sum()
    if dst is not None:
        loss = loss + (h * dst.double()).sum()
    return torch.autograd.grad(loss, (x, bm, cm, dt, da))


def _scales(want, ins):
    """max |want| of each gradient; d(da)'s at least max |dt d(dt)|."""
    sc = [float(w.abs().max()) for w in want]
    sc[4] = max(sc[4], float((ins[3].double() * want[3].double()).abs()
                              .max()))
    return sc


def _assert_within(got, want, ins, what):
    for name, g, w, sc in zip(NAMES, got, want, _scales(want, ins)):
        assert g.shape == w.shape, (what, name)
        err = float((g.double() - w.double()).abs().max())
        assert err <= TOL * sc, f"{what} {name}: {err} > {TOL} * {sc}"


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    label, (b, s, nh, ds), chunk, zero, with_state = request.param
    xbc, dt, da, dy, dst = _inputs(len(label) * 7 + s, b, s, nh, ds, zero)
    ins = _views(xbc, dt, da, nh, ds)
    dy_t = torch.from_numpy(dy)
    dst_t = torch.from_numpy(dst) if with_state else None
    return {"ins": ins, "dy": dy_t, "dst": dst_t, "chunk": chunk,
            "got": ref.ssd_chunked_bwd(*ins, dy_t, dst_t, chunk=chunk),
            "plain": _autograd(ins, dy_t, dst_t, chunk), "zero": zero,
            "np": (xbc, dt, da, dy), "dims": (b, s, nh, ds)}


def test_plain_backward_matches_autograd(case):
    _assert_within(case["got"], case["plain"], case["ins"], "vs autograd")
    for g in case["got"]:
        assert g.dtype == torch.float32 and g.is_contiguous()
    if case["zero"] is not None:
        # a head with dt = 0 adds nothing to y or the state: x gets no
        # gradient through it
        assert bool((case["got"][0][:, :, case["zero"]] == 0).all())


def test_plain_backward_and_autograd_match_float64(case):
    want = _recurrence64(case["ins"], case["dy"], case["dst"])
    _assert_within(case["plain"], want, case["ins"], "autograd vs f64")
    _assert_within(case["got"], want, case["ins"], "plain bwd vs f64")


def test_plain_backward_matches_jax_vjp_of_the_recurrence(case):
    """jax.vjp of the reference's exact recurrence in the Pallas layout
    (BH, S, ...), B and C broadcast to every head: their per-head
    gradients summed over the heads are dB and dC.  The recurrence returns
    y only, so d(final state) is not passed on either side."""
    xbc, dt, da, dy = case["np"]
    b, s, nh, ds = case["dims"]
    x, bm, cm = (np.asarray(v) for v in case["ins"][:3])

    def heads(t):
        return np.broadcast_to(t[:, :, None], (b, s, nh, ds)).transpose(
            0, 2, 1, 3).reshape(b * nh, s, ds)
    px = (x.transpose(0, 2, 1, 3).reshape(b * nh, s, 64), heads(bm),
          heads(cm), dt.transpose(0, 2, 1).reshape(b * nh, s),
          da.transpose(0, 2, 1).reshape(b * nh, s))
    _, vjp = jax.vjp(jref.ssd_scan, *map(jnp.asarray, px))
    pdy = dy.transpose(0, 2, 1, 3).reshape(b * nh, s, 64)
    jdx, jdb, jdc, jddt, jdda = (np.asarray(g) for g in vjp(
        jnp.asarray(pdy)))

    def model(g, width):      # (BH, S, w) -> (B, S, nh, w)
        return g.reshape(b, nh, s, width).transpose(0, 2, 1, 3)
    want = [torch.from_numpy(np.ascontiguousarray(v)) for v in (
        model(jdx, 64), model(jdb, ds).sum(2), model(jdc, ds).sum(2),
        jddt.reshape(b, nh, s).transpose(0, 2, 1),
        jdda.reshape(b, nh, s).transpose(0, 2, 1))]
    got = ref.ssd_chunked_bwd(*case["ins"], case["dy"],
                              chunk=case["chunk"])
    _assert_within(got, want, case["ins"], "vs jax.vjp")


# ------------------------------------------------------ the kernel source
def test_backward_source_rules():
    """ssd_bwd.cu: ``BWD_KERNELS`` launches behind its entry, no atomics
    (every sum in a fixed order), L summed in order by one thread a head
    with the forward's scan (the same loop as ssd.cu's), decays as expf of
    a difference masked to -inf, d(da) summed from the chunk's end, no
    gradient stored past S, and every product a split TF32 mma.sync (the
    operands through ``split``, the products through mma3 or mma3n)."""
    text = (CSRC / "ssd_bwd.cu").read_text()
    fwd = (CSRC / "ssd.cu").read_text()
    assert len(re.findall(r"<<<", text)) == ssd_mod.BWD_KERNELS == 3
    assert not re.search(r"\batomic\w*\(", text)
    body = re.compile(r"void scan_L\(float\* L\) \{(.*?)\n\}", re.S)
    assert body.search(text)[1] == body.search(fwd)[1]
    # one thread a head, in the states kernel and in the chunk kernel
    assert text.count("if (tid < nhg) scan_L(sm.L + tid * kChunk);") == 2
    assert len(re.findall(r"scan_L\(", text)) == 3   # its definition too
    for i, j in (("i1", "j1"), ("i2", "j1"), ("i1", "j2"), ("i2", "j2")):
        assert (f"expf({j} <= {i} ? l{i} - l{j} : neg_inf())" in text)
    assert "if (i < n) out[i * nh] = run;" in text
    assert "if (j1 < n)" in text and "if (row >= n) continue;" in text
    assert "if (j < n)" in text
    # tensor cores: one mma.sync, in TF32, on split operands only
    assert text.count("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32") \
        == 1
    assert "(__float_as_uint(v) + 0x1000u) & 0xffffe000u" in text
    # operands are rounded to TF32 only by split (hi and lo)
    code = re.sub(r"//[^\n]*", "", text)
    assert re.findall(r"\btf32\([^)]*\)?", code) == [
        "tf32(float v)", "tf32(v)", "tf32(v - __uint_as_float(hi)"]
    calls = re.findall(r"\bmma(3n<\w+>|3)?\(", text)
    assert calls.count("") == 1 + 3 + 3      # its definition, in mma3, mma3n
    assert not re.search(r"\bmma\((acc|xa|ua|va|cbf|dbacc|dcacc|state)",
                         text)
    for acc in ("cbf[kk]", "acc[kk]", "ua[p],", "va[p],", "xa[0],",
                "xa[1],", "xa[p],", "dbacc[p],", "dcacc[p],", "acc,"):
        assert re.search(r"mma3(n<\w+>)?\(" + re.escape(acc), text), acc
    assert "cp.async.cg.shared.global" in text
    assert 'extern "C" int firm_ssd_scan_bwd(' in text
    assert 'extern "C" int firm_ssd_bwd_occupancy(' in text


def _struct_bytes(text, name, consts):
    """Bytes of ``struct name {...}`` in ``text``: its arrays of float and
    float4, a union's members overlaid."""
    src = re.search(r"struct " + name + r" \{(.*?)\n\};", text, re.S)[1]
    src = re.sub(r"//[^\n]*", "", src)

    decl = r"(float4?) (\w+)((?:\[[^\]]+\])+);"

    def size(kind, dims):
        n = 1
        for f in re.findall(r"\[([^\]]+)\]", dims):
            for part in f.split("*"):
                n *= consts[part.strip()]
        return n * (16 if kind == "float4" else 4)
    union = re.search(r"union \{(.*?)\n  \} u;", src, re.S)
    total = 0
    if union:
        members = re.findall(r"struct \{(.*?)\} \w+;|" + decl, union[1],
                             re.S)
        total += max(
            sum(size(k, d) for k, _, d in re.findall(decl, inner)) if inner
            else size(kind, dims) for inner, kind, _, dims in members)
        src = src.replace(union[0], "")
    assert "[" not in re.sub(decl, "", src)     # every array counted
    return total + sum(size(k, d) for k, _, d in re.findall(decl, src))


def test_backward_shared_memory_fits_an_sm():
    """The chunk kernel's tiles at ds = 64 (C, B, one head's x and dy, whose
    room G^T takes after the heads, its h0 and dh, S^T's 72 tiles in
    fragment order, every head's L, dt and dL, the sums): 224,640 bytes,
    one block of 8 warps an H100 SM (227 KB of dynamic shared memory at
    most); two would need 113 KB each.  The states kernel's (two heads' x
    or dy, the chunk's B or C, every head's L and dt, two heads' w):
    107,520 bytes, two blocks of 8 warps an SM."""
    text = (CSRC / "ssd_bwd.cu").read_text()
    consts = {"kChunk": 128, "kHd": 64, "DS": 64, "kGroup": 8, "kTiles": 72,
              "32": 32, "2": 2, "8": 8, "4": 4}
    chunk = _struct_bytes(text, "ChunkSmem", consts)
    assert chunk == 224_640
    assert 2 * (chunk + 1024) > 228 * 1024 >= chunk + 1024
    assert chunk <= 232_448
    assert "__launch_bounds__(kThreads, 1)" in text
    assert "constexpr int kThreads = 256;" in text
    states = _struct_bytes(text, "StatesSmem", consts)
    assert states == 107_520
    assert 2 * (states + 1024) <= 228 * 1024
    assert "__launch_bounds__(kPreThreads, 2)" in text
    assert "constexpr int kGroup = 8;" in text


# ------------------------------------------------------ the wrapper
def test_backward_wrapper_refuses_cpu_tensors_before_any_launch():
    xbc, dt, da, dy, _ = _inputs(3, 1, 8, 2, 16)
    ins = _views(xbc, dt, da, 2, 16)
    before = ssd_mod.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.ssd_scan_bwd(*ins, torch.from_numpy(dy))
    assert ssd_mod.bwd_launches == before


def test_ssd_function_saves_and_launches_only_for_a_gradient(monkeypatch):
    """``SSDScan`` with the kernels' entries replaced by CPU stand-ins: with
    no input needing a gradient (the Mamba2 layers before the first
    adapter) it saves nothing and no backward runs; with one it saves the
    five inputs, and the backward hands dy and d(final state) to
    ``ssd_scan_bwd`` once."""
    calls = []

    def fwd(x, bm, cm, dt, da, *, chunk, return_state):
        y, st = ref.ssd_chunked(x, bm, cm, dt, da, chunk=chunk)
        return (y, st) if return_state else y

    def bwd(x, bm, cm, dt, da, dy, dstate=None, *, chunk):
        calls.append(dstate)
        return ref.ssd_chunked_bwd(x, bm, cm, dt, da, dy, dstate,
                                   chunk=chunk)
    monkeypatch.setattr(ssd_mod, "ssd_scan", fwd)
    monkeypatch.setattr(ssd_mod, "ssd_scan_bwd", bwd)
    xbc, dt, da, dy, dst = _inputs(4, 2, 20, 2, 16)
    ins = _views(xbc, dt, da, 2, 16)
    saved = []
    ctx = types.SimpleNamespace(save_for_backward=lambda *a: saved.extend(a))
    y = ssd_mod.SSDScan.forward(ctx, *ins, 16, False, False)
    assert saved == [] and torch.equal(y, ref.ssd_chunked(*ins,
                                                          chunk=16)[0])
    with torch.no_grad():
        ssd_mod.ssd_scan_trainable(*_views(xbc, dt, da, 2, 16,
                                           requires_grad=True),
                                   chunk=16).sum()
    y = ssd_mod.ssd_scan_trainable(*ins, chunk=16)
    assert y.grad_fn is None and calls == []
    ssd_mod.SSDScan.forward(ctx, *ins, 16, True, True)
    assert len(saved) == 5
    # with gradients: one backward, the kernels' formulas, dstate handed on
    leaves = _views(xbc, dt, da, 2, 16, requires_grad=True)
    y, st = ssd_mod.ssd_scan_trainable(*leaves, chunk=16, return_state=True)
    dy_t, dst_t = torch.from_numpy(dy), torch.from_numpy(dst)
    got = torch.autograd.grad((y, st), leaves, (dy_t, dst_t))
    assert len(calls) == 1 and torch.equal(calls[0], dst_t)
    want = _autograd(ins, dy_t, dst_t, 16)
    _assert_within(got, want, ins, "SSDScan vs autograd")


def test_ops_ssd_scan_on_the_cpu_differentiates_the_plain_version():
    """A CPU tensor takes ref.ssd_chunked under autograd: never the
    kernels' function, whose entries would refuse it."""
    xbc, dt, da, dy, _ = _inputs(5, 1, 20, 2, 16)
    leaves = _views(xbc, dt, da, 2, 16, requires_grad=True)
    before = (ssd_mod.launches, ssd_mod.bwd_launches)
    y = ops.ssd_scan(*leaves, chunk=16)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert (ssd_mod.launches, ssd_mod.bwd_launches) == before
    want = ref.ssd_chunked_bwd(*leaves, torch.from_numpy(dy), chunk=16)
    _assert_within(got, want, leaves, "ops on the CPU")
