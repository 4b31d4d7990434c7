"""The plain reference forward of the benchmark's configurations.

Plain PyTorch, float32 throughout, no kernels, no cache: the sequence
forward of the block kinds the benchmark runs (``attn``, ``swa``,
``moe``, ``moe_swa``, ``mamba2``, ``shared_attn``), written from the
published descriptions (Zamba2, arXiv:2411.15242; Mixtral,
arXiv:2401.04088) in the parameter layout of ``firmbench.weights``.

Departures from a textbook forward, each one the system's documented
semantics that the reference has to share to be compared with it:

* RoPE rotates interleaved pairs ``(x[0::2], x[1::2])``.
* LoRA adds ``(32 / r) (x A) B`` on each attention projection.
* The MoE FFN routes top-k with the gates renormalised over the k
  choices, and drops a choice past its expert's capacity ``cap =
  round_up(max(k, floor(S k / E cf)), 8)`` with priority (s, k) in a
  batch row.  ``segments`` says which positions were routed together:
  a generation routes the prompt as one block of P positions and then
  each new token alone (a block of one, which never drops).
* The Switch load-balance loss of each MoE layer is added to every
  objective's loss; its routing fractions come from the whole batch,
  which a forward over a block of rows receives as ``moe_frac``.
* Mamba2's SSD scan is the exact chunked form (chunk 128) of the
  recurrence h_t = exp(da_t) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t.

``quant="fp8"`` rounds the activation operand of every base-weight
product to float8 e4m3 per row (scaled to the format's range) and
multiplies in float32 by weights rounded to fp8 per output column
(``round.to_f32``): the precision a later change could tempt the
program into, which the benchmark's control runs in the program's
place.  The router, the LoRA factors and the attention and SSM products
stay float32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

LORA_ALPHA = 32.0
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (absmax to 448), returned in float32.  The gradient passes the
    rounding unchanged (the backward's products take the rounded
    operands, and the incoming gradient stays float32)."""
    with torch.no_grad():
        amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
        scale = amax / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach() if x.requires_grad else q


def matmul(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    """x (..., din) @ w (din, dout) in float32; with ``quant="fp8"`` x is
    rounded to fp8 per row first (w comes rounded: ``round.to_f32``)."""
    if quant == "fp8":
        x = _fp8(x, -1)
    return x @ w.float()


def linear(p: dict, x: torch.Tensor, quant: Optional[str] = None):
    y = matmul(x, p["w"], quant)
    if "lora_A" in p:
        a, b = p["lora_A"].float(), p["lora_B"].float()
        y = y + (LORA_ALPHA / a.shape[-1]) * ((x @ a) @ b)
    return y


def rms_norm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) rotated by position s in interleaved pairs."""
    s, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def attention(cfg: dict, p: dict, h: torch.Tensor, window: int,
              quant: Optional[str]) -> torch.Tensor:
    """Causal GQA self-attention (a window keeps keys j with i - j <
    window), softmax in float32."""
    b, s, _ = h.shape
    hq, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg["d_model"] // hq if not cfg.get("head_dim") else cfg["head_dim"]
    q = rope(linear(p["wq"], h, quant).reshape(b, s, hq, dh),
             cfg["rope_theta"])
    k = rope(linear(p["wk"], h, quant).reshape(b, s, hkv, dh),
             cfg["rope_theta"])
    v = linear(p["wv"], h, quant).reshape(b, s, hkv, dh)
    g = hq // hkv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    i = torch.arange(s, device=h.device)
    keep = i[:, None] >= i[None, :]
    if window:
        keep &= (i[:, None] - i[None, :]) < window
    scores = scores.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    return linear(p["wo"], o.reshape(b, s, hq * dh), quant)


def swiglu(p: dict, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    return linear(p["w_down"], F.silu(linear(p["w_gate"], x, quant))
                  * linear(p["w_up"], x, quant), quant)


def capacity(moe: dict, s: int) -> int:
    k, e, cf = moe["top_k"], moe["n_experts"], moe["capacity_factor"]
    return -(-max(k, math.floor(s * k / e * cf)) // 8) * 8


def moe_ffn(cfg: dict, p: dict, x: torch.Tensor, segments: Sequence,
            moe_frac: Optional[torch.Tensor], n_tokens: int,
            quant: Optional[str]):
    """x (B, S, d) -> (y, aux, frac counts (E,)).

    Each (start, end) of ``segments`` routes positions [start, end) of a
    row together, with that block's capacity.  ``moe_frac`` is the whole
    batch's share of choices per expert (None: this call's own), and the
    load-balance loss averages the probabilities over ``n_tokens``, the
    batch's tokens."""
    moe = cfg["moe"]
    e, k = moe["n_experts"], moe["top_k"]
    b, s, d = x.shape
    probs = torch.softmax(x @ p["router"]["w"].float(), dim=-1)
    gate, ids = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    choice = F.one_hot(ids, e).float()                    # (B, S, k, E)
    counts = choice.sum((0, 1, 2))
    frac = counts / (b * s * k) if moe_frac is None else moe_frac
    aux = moe["router_aux_weight"] * e * torch.sum(
        frac * probs.sum((0, 1)) / n_tokens)
    keep = torch.ones((b, s, k), dtype=torch.bool, device=x.device)
    for start, end in segments:
        if end - start == 1:
            continue                # one token a row: never past capacity
        seg = choice[:, start:end].reshape(b, (end - start) * k, e)
        before = torch.cumsum(seg, dim=1) - seg          # earlier choices
        pos = (before * seg).sum(-1)                      # slot in expert
        keep[:, start:end] = (pos < capacity(moe, end - start)).reshape(
            b, end - start, k)
    w = p["experts"]
    y = torch.zeros_like(x)
    xf = x.reshape(b * s, d)
    for j in range(e):
        hit = (ids == j) & keep                           # (B, S, k)
        rows = hit.any(-1).reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g_row = (gate * hit).sum(-1).reshape(-1)[rows]
        xr = xf[rows]
        hmid = F.silu(matmul(xr, w["w_gate"][j], quant)) * matmul(
            xr, w["w_up"][j], quant)
        out = matmul(hmid, w["w_down"][j], quant) * g_row[:, None]
        y = y.reshape(b * s, d).index_add(0, rows, out).reshape(b, s, d)
    return y, aux, counts


def dims(cfg: dict):
    din = cfg["ssm_expand"] * cfg["d_model"]
    return din, din // cfg["ssm_head_dim"], cfg["ssm_head_dim"], \
        cfg["ssm_state"]


def ssd(x, bmat, cmat, dt, da, chunk: int = 128):
    """Chunked SSD: x (B, S, nh, hd), B/C (B, S, ds), dt/da (B, S, nh) ->
    y (B, S, nh, hd), all float32."""
    b, s, nh, hd = x.shape
    ds = bmat.shape[-1]
    n = -(-s // chunk)
    pad = n * chunk - s

    def rs(t):
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t.reshape((b, n, chunk) + t.shape[2:])

    xc, bc, cc, dtc, dac = (rs(t) for t in (x, bmat, cmat, dt, da))
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    state = x.new_zeros((b, nh, hd, ds))
    ys = []
    for c in range(n):
        xk, bk, ck, dtk, dak = xc[:, c], bc[:, c], cc[:, c], dtc[:, c], \
            dac[:, c]
        L = torch.cumsum(dak, dim=1)                            # (B, C, nh)
        decay = torch.exp((L[:, :, None] - L[:, None]).masked_fill(
            ~causal[None, :, :, None], float("-inf")))          # (B,i,j,nh)
        w_ij = torch.einsum("bis,bjs->bij", ck, bk)[..., None] * decay \
            * dtk[:, None]
        y = torch.einsum("bijh,bjhd->bihd", w_ij, xk) + torch.einsum(
            "bis,bhds->bihd", ck, state) * torch.exp(L)[..., None]
        tail = (dtk * torch.exp(L[:, -1:] - L))[..., None]
        state = state * torch.exp(L[:, -1])[:, :, None, None] + \
            torch.einsum("bjhd,bjs->bhds", xk * tail, bk)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s]


def mamba2(cfg: dict, p: dict, x: torch.Tensor, quant: Optional[str]):
    din, nh, hd, ds = dims(cfg)
    b, s, _ = x.shape
    h = rms_norm(p["ln"]["g"], x, cfg["norm_eps"])
    zxbcdt = linear(p["in_proj"], h, quant)
    z, xbc, dt_raw = (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * ds],
                      zxbcdt[..., 2 * din + 2 * ds:])
    kconv = p["conv_w"].shape[0]
    padded = F.pad(xbc, (0, 0, kconv - 1, 0))
    conv = sum(padded[:, i:i + s] * p["conv_w"][i].float()
               for i in range(kconv))
    xbc = F.silu(conv + p["conv_b"].float())
    xs = xbc[..., :din].reshape(b, s, nh, hd)
    bmat, cmat = xbc[..., din:din + ds], xbc[..., din + ds:]
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    da = dt * -torch.exp(p["A_log"].float())
    y = ssd(xs, bmat, cmat, dt, da, cfg.get("ssm_chunk", 128))
    y = y + xs * p["D"].float()[None, None, :, None]
    y = (y * F.silu(z).reshape(b, s, nh, hd)).reshape(b, s, din)
    return x + linear(p["out_proj"], y, quant)


WINDOW_KINDS = ("swa", "moe_swa")
MOE_KINDS = ("moe", "moe_swa")


def block(cfg: dict, kind: str, p: dict, x: torch.Tensor, segments,
          moe_frac, n_tokens: int, quant: Optional[str]):
    """(x, aux or None, MoE choice counts or None)."""
    if kind == "mamba2":
        return mamba2(cfg, p, x, quant), None, None
    window = cfg.get("sliding_window", 0) if kind in WINDOW_KINDS else 0
    x = x + attention(cfg, p["attn"], rms_norm(p["ln1"]["g"], x,
                                               cfg["norm_eps"]),
                      window, quant)
    h2 = rms_norm(p["ln2"]["g"], x, cfg["norm_eps"])
    if kind in MOE_KINDS:
        y, aux, counts = moe_ffn(cfg, p["moe"], h2, segments, moe_frac,
                                 n_tokens, quant)
        return x + y, aux, counts
    return x + swiglu(p["mlp"], h2, quant), None, None


def layers(cfg: dict, params: dict):
    """(kind, params) of every layer in order."""
    out = []
    for period in range(cfg["n_periods"]):
        for i, kind in enumerate(cfg["pattern"]):
            if kind == "shared_attn":
                out.append((kind, params["shared"]))
            else:
                out.append((kind, _index(params["slots"][str(i)], period)))
    return out


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def forward(cfg: dict, params: dict, tokens: torch.Tensor, *,
            segments=None, moe_frac: Optional[Sequence] = None,
            n_tokens: Optional[int] = None, quant: Optional[str] = None):
    """tokens (B, S) -> dict(logits (B, S, V), hidden (B, S, d), aux
    (0-d), counts: one (E,) tensor an MoE layer)."""
    b, s = tokens.shape
    segments = segments or [(0, s)]
    n_tokens = n_tokens or b * s
    x = params["embed"][tokens].float()
    aux = torch.zeros((), device=tokens.device)
    counts, m = [], 0
    for kind, p in layers(cfg, params):
        frac = None if moe_frac is None or kind not in MOE_KINDS \
            else moe_frac[m]
        x, a, c = block(cfg, kind, p, x, segments, frac, n_tokens, quant)
        if a is not None:
            aux = aux + a
            counts.append(c)
            m += 1
    x = rms_norm(params["final_norm"]["g"], x, cfg["norm_eps"])
    return {"logits": linear(params["lm_head"], x, quant), "hidden": x,
            "aux": aux, "counts": counts}
