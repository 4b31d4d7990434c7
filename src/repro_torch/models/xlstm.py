"""xLSTM blocks: mLSTM (matrix memory, a linear attention) and sLSTM.

Counterpart of ``repro.models.xlstm``.  mLSTM keeps a (Dh, Dh) matrix
state C a head, with exponential input and forget gates and a
max-stabiliser m (arXiv:2405.04517 Eq. 19-27); sLSTM is the scalar-memory
cell with block-diagonal (per-head) recurrent weights.  Neither has a
Pallas kernel in the reference, which computes both in XLA (``lax.scan``
and einsums): the port computes them in PyTorch, each ``lax.scan`` as a
``common.scan`` (a Python loop) over time (sLSTM, and mLSTM's exact
recurrence) or over chunks (mLSTM's chunkwise-parallel form,
``mlstm_chunk > 0``), and differentiates them with autograd.  Only the
blocks' RMSNorm goes through a kernel (``kernels.ops.rmsnorm``).

Dtypes are the reference's: the gate projections ``w_if`` (mLSTM) and
``w`` (sLSTM) are f32 and the rest of the block's weights the model's
dtype; mLSTM multiplies the normalised bf16 input by the f32 ``w_if``,
which ``common.linear`` promotes to f32 as JAX does, and every state is
f32.  The decode steps update their cache in place and read nothing back
to the host, so a captured decode step holds them.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


# ------------------------------------------------------------------- mLSTM
def init_mlstm(cfg: ModelConfig, *, generator: torch.Generator, device,
               dtype=torch.bfloat16, lead: tuple = ()):
    """Random mLSTM parameters in the reference's tree (no adapters);
    ``lead`` prepends stacking axes to each leaf."""
    d = cfg.d_model
    dq = cfg.n_heads * cfg.head_dim
    kw = dict(generator=generator, device=device, lead=lead)
    return {
        "ln": common.init_norm(d, device=device, dtype=dtype, lead=lead),
        "wq": common.init_linear(d, dq, dtype=dtype, **kw),
        "wk": common.init_linear(d, dq, dtype=dtype, **kw),
        "wv": common.init_linear(d, dq, dtype=dtype, **kw),
        "w_if": common.init_linear(d, 2 * cfg.n_heads, dtype=torch.float32,
                                   **kw),
        "w_o": common.init_linear(d, dq, dtype=dtype, **kw),  # output gate
        "out_proj": common.init_linear(dq, d, dtype=dtype, **kw),
    }


def _mlstm_step(state, q, k, v, i_log, f_log):
    """One mLSTM cell step.  q, k, v: (B, H, Dh); gates: (B, H)."""
    C, n, m = state
    m_new = torch.maximum(f_log + m, i_log)                     # (B, H)
    f_act = torch.exp(f_log + m - m_new)[..., None]
    i_act = torch.exp(i_log - m_new)[..., None]
    C = C * f_act[..., None] + i_act[..., None] * \
        (k[..., :, None] * v[..., None, :])                     # (B,H,Dh,Dh)
    n = n * f_act + i_act * k
    h_num = torch.einsum("bhij,bhi->bhj", C, q)
    h_den = torch.clamp(torch.abs(torch.einsum("bhi,bhi->bh", n, q)),
                        min=1.0)
    return (C, n, m_new), h_num / h_den[..., None]


def _mlstm_scan_step(state, xs):
    """``_mlstm_step`` as a ``common.scan`` body: xs = (q, k, v, i_log,
    f_log) of one step."""
    return _mlstm_step(state, *xs)


def _mlstm_qkvg(p, cfg: ModelConfig, x, use_kernel: bool = True):
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    hin = common.rms_norm(p["ln"], x, cfg.norm_eps, use_kernel=use_kernel)
    q = common.linear(p["wq"], hin).reshape(b, s, h, dh).float()
    k = common.linear(p["wk"], hin).reshape(b, s, h, dh).float()
    k = k / math.sqrt(dh)
    v = common.linear(p["wv"], hin).reshape(b, s, h, dh).float()
    gates = common.linear(p["w_if"], hin).float()               # (B, S, 2H)
    i_log = gates[..., :h]
    f_log = F.logsigmoid(gates[..., h:] + 3.0)
    o = torch.sigmoid(common.linear(p["w_o"], hin).float())
    return q, k, v, i_log, f_log, o


def _zero_state(b: int, hh: int, dh: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((b, hh, dh, dh), **f32),
            torch.zeros((b, hh, dh), **f32), torch.zeros((b, hh), **f32))


def _mlstm_out(p, x, hs, o, state, return_state: bool):
    b, s = x.shape[:2]
    y = hs.reshape(b, s, -1) * o.reshape(b, s, -1)
    out = x + common.linear(p["out_proj"], y.to(x.dtype))
    if return_state:
        return out, {"C": state[0], "n": state[1], "m": state[2]}
    return out


def mlstm_seq(p, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False, use_kernel: bool = True):
    """x: (B, S, d) -> x + the block's output [, final state {'C', 'n',
    'm'}]: chunkwise with ``cfg.mlstm_chunk`` > 0, else the recurrence."""
    if cfg.mlstm_chunk:
        return mlstm_seq_chunked(p, cfg, x, return_state=return_state,
                                 chunk=cfg.mlstm_chunk, use_kernel=use_kernel)
    return mlstm_seq_recurrent(p, cfg, x, return_state=return_state,
                               use_kernel=use_kernel)


def mlstm_seq_recurrent(p, cfg: ModelConfig, x: torch.Tensor,
                        return_state: bool = False, use_kernel: bool = True):
    """The exact per-token recurrence (the reference's ``lax.scan``)."""
    b, s, _ = x.shape
    q, k, v, i_log, f_log, o = _mlstm_qkvg(p, cfg, x, use_kernel)
    state, hs = common.scan(_mlstm_scan_step,
                            _zero_state(b, cfg.n_heads, cfg.head_dim,
                                        x.device),
                            (q, k, v, i_log, f_log), dim=1)
    return _mlstm_out(p, x, hs, o, state, return_state)


def _mlstm_chunk_step(causal, state, xs):
    """One chunk of ``mlstm_seq_chunked`` as a ``common.scan`` body: the
    chunk's outputs (B, chunk, H, Dh) from the state at its start, and the
    state at its end.  xs = (q, k, v, i_log, f_log) of the chunk."""
    C, n, m = state
    qk, kk, vk, ik, fk = xs
    F_ = torch.cumsum(fk, dim=1)                       # (B, chunk, H)
    # log-weights: intra a[i, j] = F_i - F_j + i_j (j <= i); inter F_i + m
    a_intra = F_[:, :, None, :] - F_[:, None, :, :] + ik[:, None, :, :]
    a_intra = torch.where(causal, a_intra, -math.inf)
    m_intra = a_intra.amax(dim=2)                      # (B, chunk, H)
    m_inter = F_ + m[:, None, :]
    m_comb = torch.clamp(torch.maximum(m_intra, m_inter), min=-1e30)
    # intra-chunk numerator and denominator
    w = torch.exp(a_intra - m_comb[:, :, None, :])              # (B,i,j,H)
    qkd = torch.einsum("bihe,bjhe->bijh", qk, kk)
    h_num = torch.einsum("bijh,bjhe->bihe", w * qkd, vk)
    n_dot = torch.einsum("bijh,bjhe,bihe->bih", w, kk, qk)
    # inter-chunk
    scale_i = torch.exp(m_inter - m_comb)                       # (B,chunk,H)
    h_num = h_num + torch.einsum("bihe,bhed->bihd", qk, C) * \
        scale_i[..., None]
    n_dot = n_dot + torch.einsum("bihe,bhe->bih", qk, n) * scale_i
    # the recurrent cell's floor: max(|n . q|, 1)
    h = h_num / torch.clamp(torch.abs(n_dot), min=1.0)[..., None]
    # the state at the chunk's end
    F_last = F_[:, -1:, :]                                      # (B, 1, H)
    g = F_last - F_ + ik
    m_state = torch.maximum(F_last[:, 0] + m, g.amax(dim=1))    # (B, H)
    wS = torch.exp(g - m_state[:, None, :])
    decay = torch.exp(F_last[:, 0] + m - m_state)
    C = C * decay[..., None, None] + \
        torch.einsum("bjh,bjhe,bjhd->bhed", wS, kk, vk)
    n = n * decay[..., None] + torch.einsum("bjh,bjhe->bhe", wS, kk)
    return (C, n, m_state), h


def mlstm_seq_chunked(p, cfg: ModelConfig, x: torch.Tensor,
                      return_state: bool = False, chunk: int = 64,
                      use_kernel: bool = True):
    """Chunkwise-parallel mLSTM (stabilised linear attention), the
    reference's ``mlstm_seq_chunked``: within a chunk a decay-masked
    (q . k) quadratic form, across chunks the (B, H, Dh, Dh) state.

    A ragged tail is padded with steps that change nothing: i_log =
    -1e30 (no input) and f_log = 0 (no decay).  The causal mask is -inf,
    and the stabiliser is floored at -1e30, so that no exp(-inf - -inf)
    reaches autograd.
    """
    b, s, _ = x.shape
    hh, dh = cfg.n_heads, cfg.head_dim
    q, k, v, i_log, f_log, o = _mlstm_qkvg(p, cfg, x, use_kernel)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_log = F.pad(i_log, (0, 0, 0, pad), value=-1e30)
        f_log = F.pad(f_log, (0, 0, 0, pad))
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    xs = (q.reshape(b, nc, chunk, hh, dh), k.reshape(b, nc, chunk, hh, dh),
          v.reshape(b, nc, chunk, hh, dh), i_log.reshape(b, nc, chunk, hh),
          f_log.reshape(b, nc, chunk, hh))
    state, hs = common.scan(functools.partial(_mlstm_chunk_step, causal),
                            _zero_state(b, hh, dh, x.device), xs, dim=1)
    hs = hs.reshape(b, nc * chunk, hh, dh)[:, :s]
    return _mlstm_out(p, x, hs, o, state, return_state)


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device,
                     lead: tuple = ()):
    """Zero f32 C (B, H, Dh, Dh), n (B, H, Dh) and m (B, H); ``lead``
    prepends stacking axes."""
    hh, dh = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(lead + (batch, hh, dh, dh), **f32),
            "n": torch.zeros(lead + (batch, hh, dh), **f32),
            "m": torch.zeros(lead + (batch, hh), **f32)}


def mlstm_decode(p, cfg: ModelConfig, x: torch.Tensor, cache):
    """One step.  x: (B, 1, d) -> (x + output, cache), the cache's C, n
    and m updated in place."""
    b = x.shape[0]
    q, k, v, i_log, f_log, o = _mlstm_qkvg(p, cfg, x)
    state, h = _mlstm_step((cache["C"], cache["n"], cache["m"]), q[:, 0],
                           k[:, 0], v[:, 0], i_log[:, 0], f_log[:, 0])
    for name, t in zip(("C", "n", "m"), state):
        cache[name].copy_(t)
    y = h.reshape(b, 1, -1) * o
    return x + common.linear(p["out_proj"], y.to(x.dtype)), cache


# ------------------------------------------------------------------- sLSTM
def init_slstm(cfg: ModelConfig, *, generator: torch.Generator, device,
               dtype=torch.bfloat16, lead: tuple = ()):
    """Random block-diagonal sLSTM parameters in the reference's tree: the
    f32 input projection ``w`` (d, 4d), the f32 per-head recurrent
    matrices ``r`` (H, d/H, 4 d/H) and bias ``b`` (4d), and the model-dtype
    ``ln`` and ``out_proj``."""
    d, hh = cfg.d_model, cfg.n_heads
    dh = d // hh
    kw = dict(generator=generator, device=device)
    return {
        "ln": common.init_norm(d, device=device, dtype=dtype, lead=lead),
        "w": common.init_linear(d, 4 * d, dtype=torch.float32, lead=lead,
                                **kw),
        "r": common.normal(lead + (hh, dh, 4 * dh), 1.0 / math.sqrt(dh),
                           torch.float32, **kw),
        "b": torch.zeros(lead + (4 * d,), dtype=torch.float32,
                         device=device),
        "out_proj": common.init_linear(d, d, dtype=dtype, lead=lead, **kw),
    }


def _recur(p, d: int, h: torch.Tensor) -> torch.Tensor:
    """Block-diagonal recurrent projection: (B, d) -> (B, 4d), regrouped
    from the head-major layout to (i | f | z | o) x d."""
    hh, dh, _ = p["r"].shape
    b = h.shape[0]
    pre = torch.einsum("bhe,hef->bhf", h.reshape(b, hh, dh), p["r"])
    return pre.reshape(b, hh, 4, dh).movedim(2, 1).reshape(b, 4 * d)


def _slstm_step(p, d: int, state, wx_t):
    c, n, h, m = state                                           # (B, d) each
    pre = wx_t + _recur(p, d, h) + p["b"]                        # (B, 4d)
    i_log, f_pre, z_pre, o_pre = torch.split(pre, d, dim=-1)
    f_log = F.logsigmoid(f_pre + 3.0)
    m_new = torch.maximum(f_log + m, i_log)
    i_act = torch.exp(i_log - m_new)
    f_act = torch.exp(f_log + m - m_new)
    c = f_act * c + i_act * torch.tanh(z_pre)
    n = f_act * n + i_act
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
    return (c, n, h, m_new), h


def _slstm_in(p, cfg: ModelConfig, x, use_kernel: bool = True):
    """The f32 input projection of every step: (B, S, 4d)."""
    hin = common.rms_norm(p["ln"], x, cfg.norm_eps,
                          use_kernel=use_kernel).float()
    return common.linear(p["w"], hin)


def slstm_seq(p, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False, use_kernel: bool = True):
    """x: (B, S, d) -> x + the block's output [, final state {'c', 'n',
    'h', 'm'}]; the recurrence runs step by step."""
    b, s, d = x.shape
    wx = _slstm_in(p, cfg, x, use_kernel)
    z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    # the body binds what it reads of the block: the recurrent weights
    state, hs = common.scan(
        functools.partial(_slstm_step, {"r": p["r"], "b": p["b"]}, d),
        (z, z, z, z), wx, dim=1)
    out = x + common.linear(p["out_proj"], hs.to(x.dtype))
    if return_state:
        return out, dict(zip(("c", "n", "h", "m"), state))
    return out


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device,
                     lead: tuple = ()):
    """Zero f32 c, n, h and m (B, d); ``lead`` prepends stacking axes."""
    return {name: torch.zeros(lead + (batch, cfg.d_model),
                              dtype=torch.float32, device=device)
            for name in ("c", "n", "h", "m")}


def slstm_decode(p, cfg: ModelConfig, x: torch.Tensor, cache):
    """One step.  x: (B, 1, d) -> (x + output, cache), the cache's c, n, h
    and m updated in place."""
    d = cfg.d_model
    wx = _slstm_in(p, cfg, x)[:, 0]
    names = ("c", "n", "h", "m")
    state, h = _slstm_step(p, d, tuple(cache[k] for k in names), wx)
    for name, t in zip(names, state):
        cache[name].copy_(t)
    return x + common.linear(p["out_proj"], h[:, None].to(x.dtype)), cache
