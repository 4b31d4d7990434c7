"""Plain PyTorch versions of the ported kernels (mirror ``repro.kernels.ref``).

The CPU path of the port runs these, the tests hold them against the JAX
oracles, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  ``rmsnorm_bwd`` and ``flash_attention_bwd`` are the plain versions
of the backward kernels: the gradients autograd takes of ``rmsnorm`` and
``flash_attention`` (JAX's autodiff of the same functions).
``dequantize_residual`` is the plain version of the dequantize kernel's
error-feedback epilogue.  ``abs_threshold_count`` and
``abs_threshold_mask`` also take a stack of C clients' blocks with one
threshold each.  ``ssd_scan`` is the exact per-step SSD recurrence in the
Pallas kernel's layout; ``ssd_chunked`` is the chunked SSD of
``repro.models.ssm.mamba2_seq`` in the model's layout, and the plain
version of the SSD kernel.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gram(x: torch.Tensor) -> torch.Tensor:
    """(M, d) -> (M, M) Gram matrix, f32 accumulation."""
    xf = x.float()
    return xf @ xf.T


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0
                    ) -> torch.Tensor:
    """q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, Hq, Dh).

    Naive materialised softmax attention in f32; query i and key j sit at
    absolute positions i and j.
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qpk = hq // hkv
    kx = k.repeat_interleave(qpk, dim=2).float()
    vx = v.repeat_interleave(qpk, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * dh ** -0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if sliding_window:
        mask &= qp - kp < sliding_window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx)
    return o.to(q.dtype)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """Normalise in f32, round to ``x.dtype``, then scale by ``g``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def rmsnorm_dg(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """dg of ``rmsnorm(x, g, eps)`` given dy: the product ``dy * n``
    rounded to ``x.dtype`` (``n`` the forward's rounded normalised x), as
    autograd's is, summed over the rows in f32 and rounded once."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    n = (xf * r).to(x.dtype)
    return (dy * n).float().reshape(-1, x.shape[-1]).sum(0).to(g.dtype)


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """dx of ``rmsnorm(x, g, eps)`` given dy (dg: ``rmsnorm_dg``).

    ``dy * g`` is rounded to ``x.dtype``, as autograd's product is, and the
    rest runs in f32: ``r * (dn - n * mean(dn * n))`` with ``n = x * r``.
    """
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    n = xf * r
    dn = (dy * g).float()
    return (r * (dn - n * torch.mean(dn * n, dim=-1, keepdim=True))
            ).to(x.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        sliding_window: int = 0):
    """(dq, dk, dv) of ``flash_attention`` given the output gradient ``do``:
    autograd of the plain forward in f32, cast to the inputs' dtype."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        o = flash_attention(qf, kf, vf, causal=causal,
                            sliding_window=sliding_window)
        dq, dk, dv = torch.autograd.grad(o, (qf, kf, vf), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


INV_2_32 = 2.0 ** -32


def quantize(x2: torch.Tensor, bits: torch.Tensor, qmax: int = 127):
    """Blockwise symmetric quantization, as ``repro.kernels.ref.quantize``.

    x2: (R, B) f32; bits: (R, B) int32 holding the uint32 rounding offsets'
    bit patterns (2**31 = exactly round-to-nearest).  Returns ((R, B) int8
    codes, (R, 1) f32 scales).  The bits widen through int64 to their
    unsigned value and round once to f32, as JAX's uint32 -> f32 does.  The
    scale is ``absmax * rn(1/qmax)``, not ``absmax / qmax``: XLA compiles
    the reference's division by the constant qmax as a multiply by its
    rounded reciprocal, which differs from the division in the last bit of
    about one row in 25 (int8).  ``x / scale`` stays a true division.
    """
    x = x2.float()
    absmax = x.abs().amax(dim=-1, keepdim=True)
    inv_qmax = torch.ones((), dtype=torch.float32, device=x.device) / qmax
    scale = torch.where(absmax > 0, absmax * inv_qmax,
                        torch.ones_like(absmax))
    r = (bits.long() & 0xFFFFFFFF).float() * INV_2_32
    q = torch.clamp(torch.floor(x / scale + r), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(R, B) int8 codes times their (R, 1) f32 scales, in f32."""
    return codes.float() * scales


def dequantize_residual(codes: torch.Tensor, scales: torch.Tensor,
                        adj: torch.Tensor) -> torch.Tensor:
    """The error-feedback residual ``adj - codes * scale``, rounded once.

    XLA contracts the reference's dequantize multiply into the residual
    subtract (one fused multiply-subtract), so the residual is the exact
    difference rounded to f32 once.  Here it is taken in f64: the product
    of a code (7 bits) and a scale (24 bits) is exact there, and so is the
    difference unless the two operands' exponents lie more than about 22
    binary orders apart, when f64 rounds it first (a double rounding that
    can differ from the single one in the last bit: the far-off case).
    """
    return (adj.double() - codes.double() * scales.double()).float()


def _per_client(x2: torch.Tensor, thresh) -> torch.Tensor:
    """The threshold as an f32 tensor that broadcasts over ``x2``'s last
    two axes: a scalar for (R, B), one value a client for (C, R, B)."""
    t = torch.as_tensor(thresh, dtype=torch.float32, device=x2.device)
    return t.reshape(t.shape + (1, 1))


def abs_threshold_count(x2: torch.Tensor, thresh) -> torch.Tensor:
    """Count of ``|x| >= thresh`` over each client's (R, B) blocks, as f32.

    x2: (R, B), or (C, R, B) with ``thresh`` of shape (C,).  The count is
    an exact integer rounded once to f32 (exact below 2**24, where the
    reference's f32 accumulation is exact too).
    """
    hit = x2.float().abs() >= _per_client(x2, thresh)
    return hit.sum(dim=(-2, -1)).float()


def abs_threshold_mask(x2: torch.Tensor, thresh) -> torch.Tensor:
    """``x`` where ``|x| >= thresh``, else +0.0; shapes as the count's."""
    x = x2.float()
    return torch.where(x.abs() >= _per_client(x2, thresh), x,
                       torch.zeros((), dtype=torch.float32, device=x.device))


def ssd_scan(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             dt: torch.Tensor, da: torch.Tensor, *, return_state: bool = False):
    """Exact SSD recurrence (per-step scan), as ``repro.kernels.ref``.

    x: (BH, S, hd); bmat/cmat: (BH, S, ds); dt/da: (BH, S).
    h_t = exp(da_t) h_{t-1} + dt_t * x_t B_t^T;  y_t = C_t . h_t.
    Returns y (BH, S, hd) in x's dtype, and with ``return_state`` also the
    final state h_S (BH, hd, ds) f32.
    """
    bh, s, hd = x.shape
    xs, bs, cs, dts, das = (t.float() for t in (x, bmat, cmat, dt, da))
    h = torch.zeros((bh, hd, bmat.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        h = torch.exp(das[:, t])[:, None, None] * h + \
            dts[:, t, None, None] * (xs[:, t, :, None] * bs[:, t, None, :])
        ys.append(torch.einsum("bds,bs->bd", h, cs[:, t]))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros_like(xs)).to(x.dtype)
    return (y, h) if return_state else y


def ssd_chunked(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                dt: torch.Tensor, da: torch.Tensor, *, chunk: int = 128):
    """The chunked SSD of ``repro.models.ssm.mamba2_seq``, in the model's
    layout, with B and C shared across heads.

    x: (B, S, nh, hd); bmat/cmat: (B, S, ds); dt/da: (B, S, nh), all f32.
    Returns (y (B, S, nh, hd), final state (B, nh, hd, ds)).  S is padded
    with zeros to a multiple of ``chunk`` (a zero dt and da leave the state
    as it was, so the final state is exact); within a chunk the decay is
    masked with -inf before ``exp``, and ``L_i - L_j`` is formed before
    it, as in the reference.
    """
    b, s, nh, hd = x.shape
    ds = bmat.shape[-1]
    nchunks = -(-s // chunk)
    pad = nchunks * chunk - s

    def rs(t):        # (B, S, ...) -> (B, n, chunk, ...), zero-padded
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t.reshape((b, nchunks, chunk) + t.shape[2:])

    xs_c, b_c, c_c, dt_c, da_c = (rs(t) for t in (x, bmat, cmat, dt, da))
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    neg_inf = torch.tensor(float("-inf"), device=x.device)
    state = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    ys = []
    for k in range(nchunks):
        xck, bck, cck, dtk, dak = (xs_c[:, k], b_c[:, k], c_c[:, k],
                                   dt_c[:, k], da_c[:, k])
        L = torch.cumsum(dak, dim=1)                          # (B, Ck, nh)
        cb = torch.einsum("bis,bjs->bij", cck, bck)           # (B, Ck, Ck)
        ldiff = L[:, :, None, :] - L[:, None, :, :]           # (B, i, j, nh)
        decay = torch.exp(torch.where(causal[None, :, :, None], ldiff,
                                      neg_inf))
        scores = cb[..., None] * decay
        scores = scores * dtk[:, None, :, :]                  # weight by dt_j
        y_intra = torch.einsum("bijh,bjhd->bihd", scores, xck)
        y_inter = torch.einsum("bis,bhds->bihd", cck, state) * \
            torch.exp(L)[:, :, :, None]
        decay_end = torch.exp(L[:, -1:, :] - L)               # (B, Ck, nh)
        w = (dtk * decay_end)[..., None]
        state_new = torch.einsum("bjhd,bjs->bhds", xck * w, bck)
        state = state * torch.exp(L[:, -1])[:, :, None, None] + state_new
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s] if ys else x.new_zeros(x.shape)
    return y, state


def ssd_chunked_bwd(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                    dt: torch.Tensor, da: torch.Tensor, dy: torch.Tensor,
                    dstate=None, *, chunk: int = 128):
    """The gradient of ``ssd_chunked`` written out, as the backward kernel
    computes it: (dx, dB, dC, d(dt), d(da)), all f32, in the inputs'
    shapes, given dy (B, S, nh, hd) and an optional d(final state) (B, nh,
    hd, ds).

    As the kernels order the work: first the state at every chunk
    boundary, h0 (the state at each chunk's start) by the forward
    recurrence and dh (the gradient of the state at each chunk's end:
    d(final state), or zero, at the last) by the backward one, dh <-
    exp(L_end) dh + sum_i exp(L_i) dy_i C_i^T; then each chunk on its own,
    from its h0 and dh.  Per chunk, with L the inclusive cumsum of da,
    g_ij = exp(L_i - L_j) (j <= i, else 0), S_ij = (C_i . B_j) g_ij dt_j
    the scores and w_j = dt_j exp(L_end - L_j):

      dS_ij = dy_i . x_j                 T_ij = dS_ij g_ij
      dx_j  = sum_i S_ij dy_i + w_j (dh B_j)
      G_ij  = sum_heads T_ij dt_j        (the gradient of C B^T)
      dC_i  = sum_j G_ij B_j + sum_heads exp(L_i) dy_i^T h0
      dB_j  = sum_i G_ij C_i + sum_heads w_j x_j^T dh
      d(dt)_j = sum_i T_ij (C_i . B_j) + exp(L_end - L_j) dw_j,
                with dw_j = x_j^T dh B_j
      dL_i  = sum_j dS_ij S_ij - sum_k dS_ki S_ki + dy_i . y_inter_i
              - dw_i w_i
      dL_end = sum_j dw_j w_j + exp(L_end) sum(dh * h0)
      d(da)_k = dL_end + sum_{i >= k} dL_i, summed from the chunk's end

    The plain version of the backward kernel is autograd of
    ``ssd_chunked``; this one states the kernel's formulas so that the
    CPU tests can hold them to it.
    """
    b, s, nh, hd = x.shape
    ds = bmat.shape[-1]
    nchunks = -(-s // chunk)
    pad = nchunks * chunk - s

    def rs(t):        # (B, S, ...) -> (B, n, chunk, ...), zero-padded
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t.reshape((b, nchunks, chunk) + t.shape[2:])

    xs_c, b_c, c_c, dt_c, da_c, dy_c = (rs(t) for t in (x, bmat, cmat, dt,
                                                        da, dy))
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    neg_inf = torch.tensor(float("-inf"), device=x.device)
    Ls = [torch.cumsum(da_c[:, k], dim=1) for k in range(nchunks)]

    # the chunk-start states, by the forward recurrence
    h0s, state = [], torch.zeros((b, nh, hd, ds), dtype=torch.float32,
                                 device=x.device)
    for k in range(nchunks):
        h0s.append(state)
        L = Ls[k]
        w = dt_c[:, k] * torch.exp(L[:, -1:, :] - L)
        state = state * torch.exp(L[:, -1])[:, :, None, None] + \
            torch.einsum("bjhd,bjs->bhds", xs_c[:, k] * w[..., None],
                         b_c[:, k])

    # the chunk-end state gradients, by the backward recurrence
    dh = (torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
          if dstate is None else dstate.float())
    dhs = [dh]
    for k in reversed(range(1, nchunks)):
        L = Ls[k]
        dh = dh * torch.exp(L[:, -1])[:, :, None, None] + torch.einsum(
            "bih,bihd,bis->bhds", torch.exp(L), dy_c[:, k], c_c[:, k])
        dhs.insert(0, dh)

    dxs, dbs, dcs, ddts, ddas = [], [], [], [], []
    for k in range(nchunks):
        xck, bck, cck, dtk, dyk = (xs_c[:, k], b_c[:, k], c_c[:, k],
                                   dt_c[:, k], dy_c[:, k])
        L, h0, dh = Ls[k], h0s[k], dhs[k]
        lend = L[:, -1]                                        # (B, nh)
        cb = torch.einsum("bis,bjs->bij", cck, bck)            # (B, i, j)
        g = torch.exp(torch.where(causal[None, :, :, None],
                                  L[:, :, None, :] - L[:, None, :, :],
                                  neg_inf))                    # (B, i, j, nh)
        scores = cb[..., None] * g * dtk[:, None, :, :]
        w = dtk * torch.exp(lend[:, None, :] - L)              # (B, j, nh)
        el = torch.exp(L)                                      # (B, i, nh)
        dS = torch.einsum("bihd,bjhd->bijh", dyk, xck) * causal[None, :, :,
                                                                 None]
        T = dS * g
        G = (T * dtk[:, None, :, :]).sum(-1)                   # (B, i, j)
        u = torch.einsum("bihd,bhds->bihs", dyk, h0)           # dy_i^T h0
        v = torch.einsum("bjhd,bhds->bjhs", xck, dh)           # x_j^T dh
        dw = torch.einsum("bjhs,bjs->bjh", v, bck)
        dx = torch.einsum("bijh,bihd->bjhd", scores, dyk) + \
            w[..., None] * torch.einsum("bhds,bjs->bjhd", dh, bck)
        dC = torch.einsum("bij,bjs->bis", G, bck) + \
            torch.einsum("bih,bihs->bis", el, u)
        dB = torch.einsum("bij,bis->bjs", G, cck) + \
            torch.einsum("bjh,bjhs->bjs", w, v)
        ddt = torch.einsum("bijh,bij->bjh", T, cb) + \
            dw * torch.exp(lend[:, None, :] - L)
        P = dS * scores
        y_dot = el * torch.einsum("bihs,bis->bih", u, cck)     # dy_i.y_inter
        dL = P.sum(2) - P.sum(1) + y_dot - dw * w
        dlend = (dw * w).sum(1) + torch.exp(lend) * (dh * h0).sum((-2, -1))
        dda = torch.flip(torch.cumsum(torch.flip(
            torch.cat([dL[:, :-1], dL[:, -1:] + dlend[:, None]], dim=1),
            [1]), dim=1), [1])
        dxs.append(dx)
        dbs.append(dB)
        dcs.append(dC)
        ddts.append(ddt)
        ddas.append(dda)

    def cat(ts):
        return torch.cat(ts, dim=1)[:, :s].contiguous()
    if not nchunks:
        z = x.new_zeros
        return (z(x.shape).float(), z(bmat.shape).float(),
                z(cmat.shape).float(), z(dt.shape).float(),
                z(da.shape).float())
    return cat(dxs), cat(dbs), cat(dcs), cat(ddts), cat(ddas)
