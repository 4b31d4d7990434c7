"""How far the port's f32 low-rank (PowerSGD) codec lies from the same math
in float64, on the CPU, and the bound that follows from it.

The codec sends an orthonormal basis Q of the range sample P = X X^T X
omega of the vector's (a, b) matrix X.  On deltas whose rows differ in
scale by exp(4 N(0, 1)), as the uplink's do, P is ill-conditioned, and
rank 4 cancels the few dominant rows of flat + state almost exactly, so
the residual is much smaller than the terms it is the difference of.  The
f32 error of the decoded vector (and so of the residual adj - decoded)
then follows cond(P): it stays within F32_ERROR_K 2^-24 cond(P) of
max |flat + state|, the terms that cancel.  ``chip_smoke.py`` holds the
card against the CPU to twice that (two f32 sides), and never to less than
1e-4.  Over these draws the largest ratio to 2^-24 cond(P) measured 2.3,
at cond(P) ~ 4, where the rounding of the final sums dominates; at
cond(P) above 1e2 it stays below 1.  And the port still matches the JAX
codec at 1e-5 on a well-conditioned draw.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comms import codec as jcodec  # noqa: E402
from repro.comms import make_codec as jmake_codec  # noqa: E402
from repro_torch.comms import codec, lowrank, make_codec  # noqa: E402

D = 2 ** 16                    # 64 rows of 1024; X is (256, 256)
RANK = 4


def _draw(seed):
    """flat, state (1e-2 of a flat's scale) and omega, from numpy: rows
    of 1024 scaled by exp(4 N(0, 1)), as chip_smoke.py's deltas."""
    rng = np.random.default_rng(seed)

    def delta():
        rows = rng.standard_normal((D // 1024, 1024)) * np.exp(
            4 * rng.standard_normal((D // 1024, 1))) * 1e-4
        return torch.from_numpy(rows.astype(np.float32).reshape(-1))
    flat, state = delta(), 1e-2 * delta()
    _, b = lowrank._matrix_shape(D)
    omega = torch.from_numpy(rng.standard_normal((b, RANK)).astype(
        np.float32))
    return flat, state, omega


def _float64_roundtrip(adj, omega):
    """The codec's math in float64: decoded Q Q^T X, from the same omega."""
    a, b = lowrank._matrix_shape(adj.numel())
    x = torch.nn.functional.pad(adj.double(), (0, a * b - adj.numel()))
    x = x.reshape(a, b)
    p = x @ (x.T @ (x @ omega.double()))
    q, _ = torch.linalg.qr(p)
    return (q @ (q.T @ x)).reshape(-1)[:adj.numel()]


@pytest.mark.parametrize("seed", range(24))
def test_f32_codec_within_its_conditioning_bound(seed):
    flat, state, omega = _draw(seed)
    _, spec = codec.tree_to_flat({"a": torch.zeros(D)})
    ef = make_codec(f"lowrank:{RANK}+ef")
    _, residual, decoded = ef.roundtrip_flat(flat, spec, state, bits=omega)
    adj = flat + state
    dec64 = _float64_roundtrip(adj, omega)
    _, p = ef.inner.range_sample(adj, omega)
    sv = torch.linalg.svdvals(p.double())
    cond = float(sv[0] / sv[-1])
    scale = float(adj.abs().max())
    bound = lowrank.F32_ERROR_K * 2.0 ** -24 * cond * scale
    assert float((decoded.double() - dec64).abs().max()) <= bound
    assert float((residual.double() - (adj.double() - dec64)).abs().max()) \
        <= bound


def test_draws_span_the_conditioning():
    """The draws above are not all easy: several have cond(P) above 1e2
    and cancel the dominant rows to a residual 20x smaller than the
    vector."""
    ef = make_codec(f"lowrank:{RANK}+ef")
    conds, cancels = [], []
    for seed in range(24):
        flat, state, omega = _draw(seed)
        adj = flat + state
        _, p = ef.inner.range_sample(adj, omega)
        sv = torch.linalg.svdvals(p.double())
        conds.append(float(sv[0] / sv[-1]))
        dec64 = _float64_roundtrip(adj, omega)
        cancels.append(float(adj.abs().max())
                       / float((adj.double() - dec64).abs().max()))
    assert sum(c > 1e2 for c in conds) >= 4
    assert max(cancels) > 20


def test_range_sample_is_what_the_payload_is_built_from():
    """Q of the payload is the QR of ``range_sample``'s P, bit for bit: the
    card's check reads cond(P) from the same P the codec used."""
    flat, state, omega = _draw(3)
    inner = lowrank.LowRankCodec(RANK)
    adj = flat + state
    pay, meta = inner.encode_flat(adj, bits=omega)
    x, p = inner.range_sample(adj, omega)
    q, _ = torch.linalg.qr(p)
    assert torch.equal(pay["q"], q.contiguous())
    assert torch.equal(pay["b"], (q.T @ x).contiguous())
    assert (meta["a"], meta["b_cols"]) == tuple(x.shape)


def test_matches_jax_on_a_well_conditioned_draw():
    """lowrank:4+ef with JAX's omega injected: decoded and residual within
    1e-5 of the scale, on a draw of this file's kind with cond(P) < 10."""
    seed = 4
    flat, state, _ = _draw(seed)
    _, b = lowrank._matrix_shape(D)
    key = jax.random.PRNGKey(seed)
    omega = np.asarray(jax.random.normal(key, (b, RANK), jnp.float32))
    ef = make_codec(f"lowrank:{RANK}+ef")
    _, p = ef.inner.range_sample(flat + state, torch.from_numpy(omega))
    sv = torch.linalg.svdvals(p.double())
    assert float(sv[0] / sv[-1]) < 10
    _, tspec = codec.tree_to_flat({"a": torch.zeros(D)})
    _, jspec = jcodec.tree_to_flat({"a": jnp.zeros(D)})
    jc = jmake_codec(f"lowrank:{RANK}+ef")
    _, jres, jdec = jc.roundtrip_stacked(
        jnp.asarray(flat.numpy())[None], jspec, [jnp.asarray(state.numpy())],
        keys=[key])
    _, tres, tdec = ef.roundtrip_stacked(flat[None], tspec, [state],
                                         bits=torch.from_numpy(omega)[None])
    for got, want in ((tdec, jdec), (tres[0], jres[0])):
        want = np.asarray(want, np.float32)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max())
