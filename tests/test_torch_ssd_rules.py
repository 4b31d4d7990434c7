"""A CPU model of the Hopper SSD kernel's arithmetic, and rules around the
SSD and Gram kernels' sources.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  ``csrc/ssd.cu`` computes its products on
tensor cores in TF32, which keeps 10 of f32's 23 mantissa bits; the model
below repeats the kernel's order of operations in PyTorch on the CPU: the
cumsum of L in order, C B^T once a chunk shared by the heads, each
head's scores from it, the operands rounded as ``cvt.rna.tf32.f32``
rounds them (to 10 mantissa bits, ties away from zero) and split into
hi + lo (hi hi + hi lo + lo hi), as the kernel splits all four products.
The products' sums themselves are taken in float64 and rounded once: the
tensor core's own accumulation order is not modelled, only the operand
rounding that dominates the error.  At a reduced zamba2 shape the model
must hold the chip gate (1e-4 of the scale) against the plain chunked
version, the exact recurrence and the JAX package's Pallas kernel in
interpret mode, and track the plain version as the card runs it (its
cumsum in order) to 1e-6.  Single TF32 on any product, or a cumsum in
another order, must not: those cases record why the kernel splits every
product and takes L in order.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

SSD_CU = build.CSRC / "ssd.cu"
GRAM_CU = build.CSRC / "gram.cu"
CHUNK = 128
GATE = 1e-4                    # chip_smoke.py's ssd gate, of the scale
PRODUCTS = ("cb", "inter", "intra", "state")
KERNEL_SPLIT = dict.fromkeys(PRODUCTS, True)    # the kernel splits all four


def tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded as cvt.rna.tf32.f32 does: the mantissa to 10 bits,
    ties away from zero (add half of the 13 dropped bits to the
    magnitude, then clear them)."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(
        torch.int32).view(torch.float32)


def tc_matmul(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b of f32 operands on the tensor core: TF32 operands, the sum
    taken exactly (float64) and rounded once to f32."""
    ah, bh = tf32(a), tf32(b)
    if not split:
        return (ah.double() @ bh.double()).float()
    al, bl = tf32(a - ah), tf32(b - bh)
    return ((al.double() @ bh.double() + ah.double() @ bl.double())
            + ah.double() @ bh.double()).float()


def serial_scan(da: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's inclusive cumsum of a chunk's 128 da values: in order,
    as torch.cumsum runs over a non-innermost axis on the card; a zero da
    past n keeps L at L[n - 1]."""
    L = da.clone()
    for k in range(1, L.shape[-1]):
        L[..., k] = L[..., k - 1] + L[..., k]
    return L


def lane_scan(da: torch.Tensor, n: int) -> torch.Tensor:
    """What a warp-parallel scan would give: four a lane in order, a
    Hillis-Steele scan of the 32 lanes' totals, the exclusive prefix
    added; positions at or past n take L[n - 1]."""
    v = da.reshape(da.shape[:-1] + (32, 4)).clone()
    for k in range(1, 4):
        v[..., k] = v[..., k - 1] + v[..., k]
    incl = v[..., 3].clone()
    lanes = torch.arange(32)
    o = 1
    while o < 32:
        up = torch.zeros_like(incl)
        up[..., o:] = incl[..., :-o]
        incl = torch.where(lanes >= o, incl + up, incl)
        o *= 2
    excl = torch.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    L = (excl[..., None] + v).reshape(da.shape)
    L[..., n:] = L[..., n - 1:n]
    return L


def ssd_model(x, bm, cm, dt, da, split=None, scan=serial_scan):
    """The kernel's arithmetic: y (B, S, nh, hd) and the final state
    (B, nh, hd, ds), f32, with the products in ``split`` (default: the
    kernel's) split in two TF32 parts and L from ``scan``."""
    split = dict(KERNEL_SPLIT if split is None else split)
    b, s, nh, hd = x.shape
    ds = bm.shape[-1]
    nc = -(-s // CHUNK)
    pad = nc * CHUNK - s

    def chunks(t):
        t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
        return t.reshape((b, nc, CHUNK) + t.shape[2:])
    xs, bs, cs, dts, das = (chunks(t.float()) for t in (x, bm, cm, dt, da))
    ii = torch.arange(CHUNK)
    causal = ii[:, None] >= ii[None, :]
    neg_inf = torch.tensor(float("-inf"))
    state = torch.zeros(b, nh, hd, ds)
    ys = []
    for k in range(nc):
        n = min(CHUNK, s - k * CHUNK)
        bk, ck = bs[:, k], cs[:, k]
        L = scan(das[:, k].transpose(1, 2), n)               # (B, nh, i)
        dtk = dts[:, k].transpose(1, 2)                      # (B, nh, j)
        cb = tc_matmul(ck, bk.transpose(1, 2), split["cb"])  # shared
        decay = torch.exp(torch.where(
            causal, L[..., :, None] - L[..., None, :], neg_inf))
        scores = (cb[:, None] * decay) * dtk[..., None, :]
        xk = xs[:, k].permute(0, 2, 1, 3)                    # (B, nh, j, d)
        y = tc_matmul(scores, xk, split["intra"])
        if k:
            y = tc_matmul(ck[:, None], state.transpose(-1, -2),
                          split["inter"]) * torch.exp(L)[..., None] + y
        w = dtk * torch.exp(L[..., -1:] - L)
        new = tc_matmul((xk * w[..., None]).transpose(-1, -2), bk[:, None],
                        split["state"])
        state = state * torch.exp(L[..., -1])[..., None, None] + new
        ys.append(y.permute(0, 2, 1, 3))
    return torch.cat(ys, 1)[:, :s], state


def _inputs(seed, b, s, nh, ds, hd=64):
    """chip_smoke.py's SSD inputs: x, B and C silu of one normal tensor,
    dt = softplus(N(0, 1)), da = dt A with A = -(1..16) over the heads."""
    rng = np.random.default_rng(seed)
    xbc = torch.nn.functional.silu(torch.from_numpy(rng.standard_normal(
        (b, s, nh * hd + 2 * ds)).astype(np.float32)))
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    bm, cm = xbc[..., nh * hd:nh * hd + ds], xbc[..., nh * hd + ds:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, nh)).astype(np.float32)))
    return x, bm, cm, dt, dt * -torch.linspace(1.0, 16.0, nh)


def _per_head(x, bm, cm, dt, da):
    b, s, nh, hd = x.shape

    def heads(t):
        return t[:, :, None].expand(b, s, nh, t.shape[-1]).permute(
            0, 2, 1, 3).reshape(b * nh, s, -1)
    return (x.permute(0, 2, 1, 3).reshape(b * nh, s, hd), heads(bm),
            heads(cm), dt.permute(0, 2, 1).reshape(b * nh, s),
            da.permute(0, 2, 1).reshape(b * nh, s))


def _recurrence64(x, bm, cm, dt, da):
    """The exact per-step recurrence of ``ref.ssd_scan`` in float64, in the
    model's layout: y (B, S, nh, hd) and the final state."""
    b, s, nh, hd = x.shape
    xd, bd, cd, dtd, dad = (t.double() for t in (x, bm, cm, dt, da))
    h = torch.zeros(b, nh, hd, bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(s):
        h = torch.exp(dad[:, t])[..., None, None] * h + \
            dtd[:, t, :, None, None] * (xd[:, t, :, :, None]
                                        * bd[:, t, None, None, :])
        ys.append(torch.einsum("bhds,bs->bhd", h, cd[:, t]))
    return torch.stack(ys, 1), h


def _plain_on_the_card(inp):
    """``ref.ssd_chunked`` with its cumsum in order, as torch.cumsum runs
    over a non-innermost axis on the card (on the CPU it sums in another
    order)."""
    cumsum = torch.cumsum

    def in_order(t, dim):
        assert dim == 1
        out = t.clone()
        for k in range(1, out.shape[1]):
            out[:, k] = out[:, k - 1] + out[:, k]
        return out
    torch.cumsum = in_order
    try:
        return ref.ssd_chunked(*inp)
    finally:
        torch.cumsum = cumsum


def _of_scale(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


# the reduced zamba2 shape: B = 2, S = 200 (a ragged second chunk), nh = 4
SHAPE = (2, 200, 4, 64)


@pytest.fixture(scope="module")
def case():
    b, s, nh, ds = SHAPE
    inp = _inputs(18, b, s, nh, ds)
    return {"inp": inp, "model": ssd_model(*inp),
            "plain": ref.ssd_chunked(*inp), "exact": _recurrence64(*inp),
            "card_plain": _plain_on_the_card(inp)}


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                     # TF32's unit at 1
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2e-7,
                      one + ulp * 0.75, 3.0, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0,
                         -0.0])
    got = tf32(v)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    assert float(((tf32(r) - r).abs() / r.abs()).max()) <= 2.0 ** -11
    assert torch.equal(tf32(tf32(r)), tf32(r))


@pytest.mark.parametrize("scan", [serial_scan, lane_scan],
                         ids=["serial", "lanes"])
def test_scans_are_a_cumsum_and_constant_past_s(scan):
    da = -torch.from_numpy(np.random.default_rng(1).random(
        (3, CHUNK)).astype(np.float32)) * 5
    for n in (128, 100, 1, 33):
        d = da.clone()
        d[:, n:] = 0
        L = scan(d, n)
        want = torch.cumsum(d.double(), -1)
        assert float((L.double() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
        assert torch.equal(L[:, n:], L[:, n - 1:n].expand(3, CHUNK - n))


@pytest.mark.parametrize("against", ["plain", "exact"])
def test_kernel_model_holds_the_gate(case, against):
    """y and the final state of the model of the kernel's arithmetic
    within 1e-4 of the scale of the plain chunked version and of the
    exact recurrence (float64)."""
    y, st = case["model"]
    y_w, st_w = case[against]
    assert _of_scale(y, y_w) <= GATE
    assert _of_scale(st, st_w) <= GATE


def test_kernel_model_matches_the_pallas_kernel(case):
    """Against the JAX package's Pallas kernel in interpret mode, on
    per-head inputs padded with zeros to whole chunks (the Pallas kernel
    takes no ragged S; a zero dt and da leave the first S rows as they
    are)."""
    b, s, nh, _ = SHAPE
    px = _per_head(*case["inp"])
    pad = -s % CHUNK
    px = [torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
          for t in px]
    y_j = np.array(pallas_ssd_scan(*(jnp.asarray(t.numpy()) for t in px),
                                   chunk=CHUNK, interpret=True))
    y_j = torch.from_numpy(y_j[:, :s]).view(b, nh, s, 64).permute(0, 2, 1, 3)
    assert _of_scale(case["model"][0], y_j) <= GATE


def test_kernel_model_tracks_the_plain_version_on_the_card(case):
    """Against the plain version with its cumsum in order, as the card
    runs it: within 1e-6 of the scale (2.8e-7 of y's was measured at
    (2, 256, 64, 64)), so that 32 Mamba2 layers do not compound the
    kernel's rounding past zamba2's f32 logits gate."""
    y, st = case["model"]
    y_w, st_w = case["card_plain"]
    assert _of_scale(y, y_w) <= 1e-6
    assert _of_scale(st, st_w) <= 1e-6


@pytest.mark.parametrize("product", PRODUCTS)
def test_single_tf32_on_any_product_leaves_the_plain_version(case,
                                                             product):
    """Single TF32 on one product, the others split: y or the state moves
    from the plain version as the card runs it more than ten times as far
    as the kernel's model does.  On C B^T, the scores times x and the state update it also misses
    the 1e-4 gate against the exact recurrence (2.6e-4 to 5.0e-4 were
    measured at (4, 256, 64, 64)); on C state^T, which exp(L_i) damps, it
    holds that gate, but its drift from the plain version (3e-5 of y's
    scale on the card at (16, 256, 64, 64)) took zamba2's f32 logits past
    theirs."""
    y, st = ssd_model(*case["inp"], split=dict(KERNEL_SPLIT,
                                               **{product: False}))
    y_p, st_p = case["card_plain"]
    y_k, st_k = case["model"]
    assert max(_of_scale(y, y_p), _of_scale(st, st_p)) > 10 * max(
        _of_scale(y_k, y_p), _of_scale(st_k, st_p))
    y_e, st_e = case["exact"]
    err = max(_of_scale(y, y_e), _of_scale(st, st_e))
    if product == "inter":
        assert err <= GATE / 2, err
    else:
        assert err > GATE, (product, err)


def test_all_single_tf32_misses_the_gate(case):
    """Every product single TF32: twice the gate against the recurrence."""
    y, _ = ssd_model(*case["inp"], split=dict.fromkeys(PRODUCTS, False))
    assert _of_scale(y, case["exact"][0]) > 2 * GATE


def test_a_lane_parallel_scan_leaves_the_plain_version(case):
    """L from a warp-parallel scan, every product split: within the 1e-4
    gate, but y moves from the plain version as the card runs it more
    than ten times as far as the kernel's model does (1.5e-5 of y's
    scale against 2.8e-7 were measured at (2, 256, 64, 64)): |L| reaches
    ~1800 in a chunk, where an ulp of L is ~1e-4 of exp(L_i - L_j)."""
    y, _ = ssd_model(*case["inp"], scan=lane_scan)
    y_p = case["card_plain"][0]
    assert _of_scale(y, case["exact"][0]) <= GATE
    assert _of_scale(y, y_p) > 10 * _of_scale(case["model"][0], y_p)


def test_ssd_source_runs_tensor_cores_as_modelled():
    """ssd.cu issues TF32 mma.sync on operands rounded as the model
    rounds them, splits all four products (mma3 and mma3n), takes L in
    order by one thread, fills its tiles by cp.async and uses no
    atomics."""
    text = SSD_CU.read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    # cvt.rna.tf32.f32's rounding of a finite value, as tf32() above
    assert "(__float_as_uint(v) + 0x1000u) & 0xffffe000u" in text
    assert "cp.async.cg.shared.global" in text
    assert "mma3(cbacc[" in text         # C B^T
    assert "mma3n<4>(acc[p]," in text    # C state^T
    assert "mma3n<4>(acc," in text       # the scores times x
    assert "mma3n<NSW>(sacc," in text    # the state update
    assert not re.search(r"\bmma\((acc|sacc|cbacc)", text)
    assert "if (tid == 0) scan_L(sm.L);" in text
    assert not re.search(r"\batomic\w*\(", text)


def test_ssd_shared_memory_fits_two_blocks_an_sm():
    """C and one head's state (whose room C B^T takes over), B, one head's
    x, L and dt at ds = 64: 115,712 bytes, the most that each of two
    blocks of an H100 SM can have (228 KB, less 1 KB a block)."""
    text = SSD_CU.read_text()
    struct = re.search(r"struct Smem \{(.*)\n\};", text, flags=re.S)[1]
    consts = {"kChunk": 128, "kHd": 64, "DS": 64, "kTiles": 72, "32": 32}
    sizes = {}
    for kind, name, expr in re.findall(r"(float4?) (\w+)\[([^\]]+)\];",
                                       struct):
        n = int(np.prod([consts[f.strip()] for f in expr.split("*")]))
        sizes[name] = n * (16 if kind == "float4" else 4)
    assert set(sizes) == {"c", "state", "cb", "b", "x", "L", "dt"}
    total = (max(sizes["c"] + sizes["state"], sizes["cb"]) + sizes["b"]
             + sizes["x"] + sizes["L"] + sizes["dt"])
    assert total == 115_712
    assert 2 * (total + 1024) <= 228 * 1024
    assert "__launch_bounds__(kThreads, 2)" in text
    assert "constexpr int kThreads = 256;" in text   # so <= 128 registers


def test_gram_source_launches_one_kernel_an_entry_call():
    """gram.cu: one kernel launch behind firm_gram (the finish kernel is
    gone), the partials summed by the last block in block order behind an
    integer ticket, no float atomics."""
    text = GRAM_CU.read_text()
    assert len(re.findall(r"<<<", text)) == 1
    assert "gram_finish_kernel" not in text
    assert re.findall(r"atomicAdd\(([^,]+),", text) == ["&g_done"]
    assert "__threadfence()" in text
    assert "g_done = 0" in text
