"""The transformer: init, sequence forward, prefill and decode.

Counterpart of ``repro.models.transformer`` for every block kind of the
reference: ``attn`` (the dense pattern), ``swa`` (sliding-window
attention), ``moe`` and ``moe_swa`` (attention, full or windowed, with
the GShard MoE FFN of ``models.moe``), ``mamba2`` and ``shared_attn``
(the zamba2 hybrid), ``mlstm`` and ``slstm`` (the xLSTM blocks of
``models.xlstm``), ``cross`` (self-attention, then cross-attention to the
cross source, then the MLP) and ``enc_attn`` (the whisper encoder's
bidirectional blocks).  Parameters use the reference's layout, so
``bridge.to_torch`` carries a JAX tree over unchanged:

  params['embed']            (V, d) token embedding
  params['slots'][str(i)]    pattern slot i's block params, stacked over
                             n_periods on the leading axis: an attention
                             block (ln1, attn.{wq,wk,wv,wo}, ln2, and
                             mlp.{w_gate,w_up,w_down} or, for the MoE
                             kinds, moe.{router.w, experts.{w_gate,w_up,
                             w_down}}; a cross block also lnx and
                             cross.{wq,wk,wv,wo}), a Mamba2 block
                             (``models.ssm``) or an mLSTM or sLSTM block
                             (``models.xlstm``); no entry for shared_attn
  params['shared']           the one attention block that every
                             'shared_attn' slot of every period runs
  params['encoder']          the whisper encoder: {'slots': {'0': its
                             enc_attn blocks stacked over encoder_layers},
                             'final_norm'}
  params['final_norm'], params['lm_head']

``aux`` carries the modality stubs, as in the reference: {'vision': (B,
Nv, d)} for a VLM, whose cross blocks attend to it, and {'frames': (B,
Te, d)} for an encoder-decoder, whose encoder turns the frames into the
cross blocks' source (``_cross_source``).  Cross-attention has no RoPE
and no mask; it runs through the flash kernel at Sq != Skv.

The periods and their slots run in Python loops, eagerly, and so do the
recurrences of the xLSTM blocks.  ``forward_seq`` records gradients (the
PPO losses differentiate it; the kernels' backward runs through their
``autograd.Function``s, the SSD scan's included) and keeps every
activation: nothing is rematerialised, where the reference checkpoints
each period (``cfg.remat``).  ``prefill`` and ``decode_step`` run under
``torch.no_grad()``, and the decode cache is updated in place: each
attention slot has its own K/V, each Mamba2 slot its own f32 conv history
and state, each mLSTM and sLSTM slot its own f32 states, each cross slot
its cross K/V (written by prefill, read by every step), per period, even
where the parameters are shared.  A sliding-window slot's K/V holds
min(window, cache_len) positions; where that is the window it is a ring
(position p at slot p % C), as prefill lays it out when the prompt fills
it.  ``forward_seq`` sums the MoE blocks' router losses into
``aux_loss``.  The cache's position ``pos`` is a 0-d int32 tensor on its
device, as in the reference, and ``decode_step`` advances it in place
and reads it only there: one decode step syncs nothing with the host, so
``rlhf.sampling`` captures it as a CUDA graph whose every replay sees
the position the last one left.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, moe as moe_lib, ssm, xlstm
from repro_torch.models.attention import chunked_attention, decode_attention

WINDOW_KINDS = ("swa", "moe_swa")
MOE_KINDS = ("moe", "moe_swa")
# the kinds whose decode cache is a state, not K/V: (init, seq, decode,
# init_cache)
RECURRENT_KINDS = {
    "mamba2": (ssm.init_mamba2, ssm.mamba2_seq, ssm.mamba2_decode,
               ssm.init_mamba2_cache),
    "mlstm": (xlstm.init_mlstm, xlstm.mlstm_seq, xlstm.mlstm_decode,
              xlstm.init_mlstm_cache),
    "slstm": (xlstm.init_slstm, xlstm.slstm_seq, xlstm.slstm_decode,
              xlstm.init_slstm_cache),
}


def _layer(stacked, i: int):
    """Period ``i`` of a tree stacked on the leading axis (views, no copy)."""
    return common.tree_map(lambda t: t[i], stacked)


def _slot_params(cfg: ModelConfig, params, i: int, period: int):
    kind = cfg.pattern[i]
    if kind == "shared_attn":
        return params["shared"]
    return _layer(params["slots"][str(i)], period)




# ================================================================== init
def _init_attn(cfg: ModelConfig, lead: tuple, **kw):
    """The four projections of one attention (LoRA on each where the
    config has adapters)."""
    rank = cfg.lora.rank if cfg.lora else 0
    d = cfg.d_model
    dq, dkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {
        "wq": common.init_linear(d, dq, lora_rank=rank, lead=lead, **kw),
        "wk": common.init_linear(d, dkv, lora_rank=rank, lead=lead, **kw),
        "wv": common.init_linear(d, dkv, lora_rank=rank, lead=lead, **kw),
        "wo": common.init_linear(dq, d, lora_rank=rank, lead=lead, **kw),
    }


def _init_block(kind: str, cfg: ModelConfig, lead: tuple, **kw):
    """One block's parameters (``lead`` stacks them, e.g. over periods)."""
    if kind in RECURRENT_KINDS:
        return RECURRENT_KINDS[kind][0](cfg, lead=lead, **kw)
    d = cfg.d_model
    dev, dtype = kw["device"], kw["dtype"]
    p = {
        "ln1": common.init_norm(d, device=dev, dtype=dtype, lead=lead),
        "attn": _init_attn(cfg, lead, **kw),
        "ln2": common.init_norm(d, device=dev, dtype=dtype, lead=lead),
    }
    if kind in MOE_KINDS:
        p["moe"] = moe_lib.init_moe(cfg, lead=lead, **kw)
    else:
        p["mlp"] = common.init_swiglu(d, cfg.d_ff, lead=lead, **kw)
    if kind == "cross":
        p["lnx"] = common.init_norm(d, device=dev, dtype=dtype, lead=lead)
        p["cross"] = _init_attn(cfg, lead, **kw)
    return p


def init_block(kind: str, cfg: ModelConfig, *, generator: torch.Generator,
               device="cuda", dtype=torch.bfloat16):
    """One block of ``kind``'s parameters, unstacked, drawn from
    ``generator`` on ``device`` (the reference's ``init_block``)."""
    return _init_block(kind, cfg, (), generator=generator,
                       device=device_lib.resolve(device), dtype=dtype)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16):
    """Random parameters drawn from ``generator`` on ``device``.

    Base weights are ``dtype`` (an MoE router and the xLSTM gate weights
    f32, as in the reference); LoRA factors (attention projections only,
    cross-attention's included, as in the reference) are f32 with
    ``lora_B = 0``.  An encoder-decoder config also gets the encoder's
    ``encoder_layers`` blocks.  The generator must live on ``device``.
    """
    dev = device_lib.resolve(device)
    d = cfg.d_model
    kw = dict(generator=generator, device=dev, dtype=dtype)
    params = {
        "embed": common.normal((cfg.vocab, d), 0.02, **kw),
        "final_norm": common.init_norm(d, device=dev, dtype=dtype),
        "lm_head": common.init_linear(d, cfg.vocab, **kw),
        "slots": {str(i): _init_block(kind, cfg, (cfg.n_periods,), **kw)
                  for i, kind in enumerate(cfg.pattern)
                  if kind != "shared_attn"},
    }
    if "shared_attn" in cfg.pattern:
        params["shared"] = _init_block("shared_attn", cfg, (), **kw)
    if cfg.encoder_layers:
        params["encoder"] = {
            "slots": {"0": _init_block("enc_attn", cfg,
                                       (cfg.encoder_layers,), **kw)},
            "final_norm": common.init_norm(d, device=dev, dtype=dtype),
        }
    return params


# ================================================================ seq mode
def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind in WINDOW_KINDS else 0


def _self_attention(p, cfg: ModelConfig, h, positions, kind: str,
                    use_kernel: bool):
    b, s, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = common.linear(p["wq"], h).reshape(b, s, hq, dh)
    k = common.linear(p["wk"], h).reshape(b, s, hkv, dh)
    v = common.linear(p["wv"], h).reshape(b, s, hkv, dh)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=kind != "enc_attn",
                          sliding_window=_window(cfg, kind),
                          use_kernel=use_kernel)
    return common.linear(p["wo"], o.reshape(b, s, hq * dh)), (k, v)


def _cross_attention(p, cfg: ModelConfig, h, cross_states,
                     use_kernel: bool):
    """Queries from h (B, S, d), keys and values from the cross source
    (B, N, d): no RoPE, no mask."""
    b, s, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = cross_states.shape[1]
    q = common.linear(p["wq"], h).reshape(b, s, hq, dh)
    k = common.linear(p["wk"], cross_states).reshape(b, n, hkv, dh)
    v = common.linear(p["wv"], cross_states).reshape(b, n, hkv, dh)
    o = chunked_attention(q, k, v, causal=False, use_kernel=use_kernel)
    return common.linear(p["wo"], o.reshape(b, s, hq * dh)), (k, v)


def _ffn(kind: str, p, cfg: ModelConfig, h2):
    """The block's FFN: (y, router aux loss or None)."""
    if kind in MOE_KINDS:
        return moe_lib.moe_ffn(p["moe"], cfg, h2)
    return common.swiglu(p["mlp"], h2), None


def block_seq(kind: str, p, cfg: ModelConfig, x, positions,
              collect_kv: bool = False, use_kernel: bool = True, *,
              cross_states=None):
    """One block in sequence mode.  Returns (x, aux, piece): ``aux`` the
    MoE router loss (None for the other kinds); with ``collect_kv`` an
    attention block's ``{'k', 'v'}`` (a cross block's also ``'ck'`` and
    ``'cv'``, its cross keys and values) or a recurrent block's final
    state (Mamba2 ``{'conv', 'state'}``, mLSTM ``{'C', 'n', 'm'}``, sLSTM
    ``{'c', 'n', 'h', 'm'}``), else None.  ``cross_states`` is a cross
    block's source (B, N, d)."""
    if kind in RECURRENT_KINDS:
        seq = RECURRENT_KINDS[kind][1]
        if collect_kv:
            x, state = seq(p, cfg, x, return_state=True,
                           use_kernel=use_kernel)
            return x, None, state
        return seq(p, cfg, x, use_kernel=use_kernel), None, None
    h = common.rms_norm(p["ln1"], x, cfg.norm_eps, use_kernel=use_kernel)
    attn_out, (k, v) = _self_attention(p["attn"], cfg, h, positions, kind,
                                       use_kernel)
    x = x + attn_out
    piece = {"k": k, "v": v} if collect_kv else None
    if kind == "cross":
        hx = common.rms_norm(p["lnx"], x, cfg.norm_eps, use_kernel=use_kernel)
        cross_out, (ck, cv) = _cross_attention(p["cross"], cfg, hx,
                                               cross_states, use_kernel)
        x = x + cross_out
        if collect_kv:
            piece.update(ck=ck, cv=cv)
    h2 = common.rms_norm(p["ln2"], x, cfg.norm_eps, use_kernel=use_kernel)
    y, aux = _ffn(kind, p, cfg, h2)
    return x + y, aux, piece


def _encoder_forward(cfg: ModelConfig, params, frames: torch.Tensor,
                     use_kernel: bool = True) -> torch.Tensor:
    """The whisper encoder: (B, Te, d) frames, cast to the model's dtype,
    through ``encoder_layers`` bidirectional blocks and the final norm."""
    enc = params["encoder"]
    x = frames.to(params["embed"].dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in range(cfg.encoder_layers):
        x = block_seq("enc_attn", _layer(enc["slots"]["0"], layer), cfg, x,
                      positions, use_kernel=use_kernel)[0]
    return common.rms_norm(enc["final_norm"], x, cfg.norm_eps,
                           use_kernel=use_kernel)


def stub_key(cfg: ModelConfig) -> Optional[str]:
    """The key of the modality stub in ``aux`` that the forward reads:
    ``'vision'`` for a VLM, ``'frames'`` for an encoder-decoder, else
    None."""
    if cfg.family == "vlm":
        return "vision"
    if cfg.is_encoder_decoder:
        return "frames"
    return None


def _cross_source(cfg: ModelConfig, params, aux, use_kernel: bool = True):
    """What the cross blocks attend to: the vision stub (a VLM), the
    encoder's output (an encoder-decoder), else None.  A missing stub
    raises ``KeyError``, as in the reference."""
    key = stub_key(cfg)
    if key == "vision":
        return aux[key].to(params["embed"].dtype)
    if key == "frames":
        return _encoder_forward(cfg, params, aux[key], use_kernel)
    return None


def forward_seq(cfg: ModelConfig, params, tokens: torch.Tensor, aux=None,
                *, collect_kv: bool = False, last_logit_only: bool = False,
                use_kernel: bool = True):
    """tokens: (B, S) -> dict(logits, hidden, aux_loss [, kv,
    cross_states]).

    ``aux`` holds the modality stub (``{'vision': ...}`` or ``{'frames':
    ...}``) of a config with cross blocks.  ``kv`` maps each slot
    ``str(i)`` to its pieces (``block_seq``) stacked over periods: e.g.
    (n_periods, B, S, Hkv, Dh) ``k`` and ``v`` for an attention slot;
    ``cross_states`` is the cross source (None without one).
    last_logit_only: logits for the final position only.  ``aux_loss`` is
    the f32 sum of the MoE blocks' router losses (zero without MoE
    blocks).
    """
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cross_states = _cross_source(cfg, params, aux or {}, use_kernel)
    pieces = {str(i): [] for i in range(len(cfg.pattern))}
    aux_loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for period in range(cfg.n_periods):
        for i, kind in enumerate(cfg.pattern):
            x, a, piece = block_seq(
                kind, _slot_params(cfg, params, i, period), cfg, x,
                positions, collect_kv, use_kernel, cross_states=cross_states)
            if a is not None:
                aux_loss = aux_loss + a
            if collect_kv:
                pieces[str(i)].append(piece)
    x = common.rms_norm(params["final_norm"], x, cfg.norm_eps,
                        use_kernel=use_kernel)
    logits = common.linear(params["lm_head"],
                           x[:, -1:] if last_logit_only else x)
    out = {"logits": logits, "hidden": x, "aux_loss": aux_loss}
    if collect_kv:
        out["kv"] = {i: {name: torch.stack([pc[name] for pc in per])
                         for name in per[0]}
                     for i, per in pieces.items()}
        out["cross_states"] = cross_states
    return out


# ============================================================== decode mode
def _attn_cache_len(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    """K/V slots of an attention slot: a window caps them."""
    window = _window(cfg, kind)
    return min(window, cache_len) if window else cache_len


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device,
               dtype=torch.bfloat16, n_cross: int = 0):
    """Pre-allocated decode cache, one entry a pattern slot, stacked over
    periods: ``dtype`` (n_periods, B, C, Hkv, Dh) K and V for attention
    slots (C = ``_attn_cache_len``), and for a cross slot its (n_periods,
    B, N, Hkv, Dh) cross K and V, N = ``n_cross`` (the cross source's
    length; a config with cross blocks and no source raises); a recurrent
    slot's f32 states; ``pos``, a 0-d int32 tensor on ``device`` (0)."""
    if "cross" in cfg.pattern and n_cross < 1:
        raise ValueError(f"{cfg.name} has cross blocks: init_cache needs "
                         f"the cross source's length n_cross, got {n_cross}")
    slots = {}
    lead = (cfg.n_periods,)
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    for i, kind in enumerate(cfg.pattern):
        if kind in RECURRENT_KINDS:
            slots[str(i)] = RECURRENT_KINDS[kind][3](cfg, batch,
                                                     device=device, lead=lead)
            continue
        shape = lead + (batch, _attn_cache_len(cfg, kind, cache_len), hkv, dh)
        piece = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
        if kind == "cross":
            cshape = lead + (batch, n_cross, hkv, dh)
            piece["ck"] = torch.zeros(cshape, dtype=dtype, device=device)
            piece["cv"] = torch.zeros(cshape, dtype=dtype, device=device)
        slots[str(i)] = piece
    return {"slots": slots,
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _ring_positions(pos: torch.Tensor, c: int) -> torch.Tensor:
    """The absolute position each of the C ring slots holds AFTER token
    ``pos`` (0-d int tensor) was written at slot pos % C; -1 where a slot
    has not been written.  Computed on pos's device."""
    j = torch.arange(c, device=pos.device)
    p = pos - ((pos - j) % c)
    return torch.where(p >= 0, p, -1)


def block_decode(kind: str, p, cfg: ModelConfig, x, cache,
                 pos: torch.Tensor):
    """One-token decode through one block at position ``pos`` (0-d int32
    tensor).  ``cache`` is this slot's and period's piece: ``{'k', 'v'}``
    (B, C, Hkv, Dh), whose slot ``pos % C`` is written in place (a ring
    when a window caps C), with a cross block's ``{'ck', 'cv'}`` (B, N,
    Hkv, Dh), read whole; or a recurrent block's state, updated in place.
    Returns x."""
    if kind in RECURRENT_KINDS:
        return RECURRENT_KINDS[kind][2](p, cfg, x, cache)[0]
    k_cache, v_cache = cache["k"], cache["v"]
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = common.rms_norm(p["ln1"], x, cfg.norm_eps)
    q = common.linear(p["attn"]["wq"], h).reshape(b, 1, hq, dh)
    k = common.linear(p["attn"]["wk"], h).reshape(b, 1, hkv, dh)
    v = common.linear(p["attn"]["wv"], h).reshape(b, 1, hkv, dh)
    posv = pos[None]
    q = common.apply_rope(q, posv, cfg.rope_theta)
    k = common.apply_rope(k, posv, cfg.rope_theta)
    c = k_cache.shape[1]
    idx = (pos % c).long()[None]                     # computed on the device
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    sw = _window(cfg, kind)
    o = decode_attention(q, k_cache, v_cache, pos, sliding_window=sw,
                         cache_positions=_ring_positions(pos, c)
                         if sw and c <= sw else None)
    x = x + common.linear(p["attn"]["wo"], o.reshape(b, 1, hq * dh))
    if kind == "cross":
        hx = common.rms_norm(p["lnx"], x, cfg.norm_eps)
        qx = common.linear(p["cross"]["wq"], hx).reshape(b, 1, hq, dh)
        # every cross position is seen: the reference's position n
        n = torch.full((), cache["ck"].shape[1], dtype=torch.int32,
                       device=x.device)
        o = decode_attention(qx, cache["ck"], cache["cv"], n)
        x = x + common.linear(p["cross"]["wo"], o.reshape(b, 1, hq * dh))
    h2 = common.rms_norm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn(kind, p, cfg, h2)[0]


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, token: torch.Tensor):
    """token: (B, 1) -> (logits (B, V), cache).

    The cache is updated in place (every slot's piece, and ``pos``, which
    advances by one) and returned.
    """
    x = params["embed"][token]
    pos = cache["pos"]
    for period in range(cfg.n_periods):
        for i, kind in enumerate(cfg.pattern):
            piece = {name: t[period]
                     for name, t in cache["slots"][str(i)].items()}
            x = block_decode(kind, _slot_params(cfg, params, i, period), cfg,
                             x, piece, pos)
    x = common.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = common.linear(params["lm_head"], x)[:, 0]
    pos.add_(1)
    return logits, cache


# ================================================================== prefill
@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, aux=None, *,
            cache_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            lay_out=None):
    """Run the sequence forward AND build a decode cache.

    Returns (logits (B, S, V), cache).  cache_len defaults to S.  ``aux``
    is the modality stub, as for ``forward_seq``.  Recurrent slots take
    the exact final states of the sequence scan; a cross slot its cross
    K/V whole.  An attention slot of C slots takes the last min(S, C)
    positions: at slots 0.. or, for a window slot with C <= S, in the
    ring layout (position p at slot p % C).  ``lay_out``, when given, maps
    the fresh cache to the one that is filled (the caller's layout of it).
    """
    b, s = tokens.shape
    cache_len = cache_len or s
    out = forward_seq(cfg, params, tokens, aux, collect_kv=True)
    cross = out["cross_states"]
    cache = init_cache(cfg, b, cache_len, device=tokens.device,
                       dtype=cache_dtype,
                       n_cross=0 if cross is None else cross.shape[1])
    if lay_out is not None:
        cache = lay_out(cache)
    for i, kind in enumerate(cfg.pattern):
        piece, kv = cache["slots"][str(i)], out["kv"][str(i)]
        if kind in RECURRENT_KINDS:
            for name in piece:
                piece[name].copy_(kv[name])
            continue
        if kind == "cross":
            for name in ("ck", "cv"):
                piece[name].copy_(kv[name])
        c = piece["k"].shape[2]
        take = min(s, c)
        if _window(cfg, kind) and c <= s:
            # ring layout: position p lives at slot p % c
            slots = torch.arange(s - take, s, device=tokens.device) % c
            for name in ("k", "v"):
                piece[name][:, :, slots] = kv[name][:, :, -take:].to(
                    cache_dtype)
            continue
        for name in ("k", "v"):
            piece[name][:, :, :take] = kv[name][:, :, -take:].to(cache_dtype)
    cache["pos"].fill_(s)
    return out["logits"], cache
