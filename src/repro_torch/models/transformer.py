"""The dense transformer: init, sequence forward, prefill and decode.

Counterpart of ``repro.models.transformer`` for the dense ``("attn",)``
pattern; any other block kind raises ``NotImplementedError``.  Parameters
use the reference's layout, so ``bridge.to_torch`` carries a JAX tree over
unchanged:

  params['embed']            (V, d) token embedding
  params['slots']['0']       block params stacked over n_periods on the
                             leading axis (ln1, attn.{wq,wk,wv,wo}, ln2,
                             mlp.{w_gate,w_up,w_down})
  params['final_norm'], params['lm_head']

The stacked layers run in a Python loop over periods, eagerly and under
``torch.no_grad()``: this slice is forward-only, so nothing is
rematerialised.  The decode cache is updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import chunked_attention, decode_attention


def _check_dense(cfg: ModelConfig) -> None:
    if tuple(cfg.pattern) != ("attn",):
        raise NotImplementedError(
            f"block pattern {cfg.pattern} is not ported yet: only the dense "
            "('attn',) pattern is; the other block kinds come with the "
            "model-families slice (ROADMAP Queue 1 item 11)")


def _layer(stacked, i: int):
    """Period ``i`` of a tree stacked on the leading axis (views, no copy)."""
    return common.tree_map(lambda t: t[i], stacked)


# ================================================================== init
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16):
    """Random parameters drawn from ``generator`` on ``device``.

    Base weights are ``dtype``; LoRA factors are f32 with ``lora_B = 0``.
    The generator must live on ``device``.
    """
    _check_dense(cfg)
    dev = device_lib.resolve(device)
    d, n = cfg.d_model, cfg.n_periods
    rank = cfg.lora.rank if cfg.lora else 0
    dq, dkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    kw = dict(generator=generator, device=dev, dtype=dtype)
    lead = (n,)
    return {
        "embed": common.normal((cfg.vocab, d), 0.02, **kw),
        "final_norm": common.init_norm(d, device=dev, dtype=dtype),
        "lm_head": common.init_linear(d, cfg.vocab, **kw),
        "slots": {"0": {
            "ln1": common.init_norm(d, device=dev, dtype=dtype, lead=lead),
            "attn": {
                "wq": common.init_linear(d, dq, lora_rank=rank, lead=lead,
                                         **kw),
                "wk": common.init_linear(d, dkv, lora_rank=rank, lead=lead,
                                         **kw),
                "wv": common.init_linear(d, dkv, lora_rank=rank, lead=lead,
                                         **kw),
                "wo": common.init_linear(dq, d, lora_rank=rank, lead=lead,
                                         **kw),
            },
            "ln2": common.init_norm(d, device=dev, dtype=dtype, lead=lead),
            "mlp": common.init_swiglu(d, cfg.d_ff, lead=lead, **kw),
        }},
    }


# ================================================================ seq mode
def _self_attention(p, cfg: ModelConfig, h, positions, use_kernel: bool):
    b, s, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = common.linear(p["wq"], h).reshape(b, s, hq, dh)
    k = common.linear(p["wk"], h).reshape(b, s, hkv, dh)
    v = common.linear(p["wv"], h).reshape(b, s, hkv, dh)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=True, use_kernel=use_kernel)
    return common.linear(p["wo"], o.reshape(b, s, hq * dh)), (k, v)


def block_seq(p, cfg: ModelConfig, x, positions, use_kernel: bool = True):
    """One dense block in sequence mode.  Returns (x, (k, v))."""
    h = common.rms_norm(p["ln1"], x, cfg.norm_eps, use_kernel=use_kernel)
    attn_out, kv = _self_attention(p["attn"], cfg, h, positions, use_kernel)
    x = x + attn_out
    h2 = common.rms_norm(p["ln2"], x, cfg.norm_eps, use_kernel=use_kernel)
    return x + common.swiglu(p["mlp"], h2), kv


@torch.no_grad()
def forward_seq(cfg: ModelConfig, params, tokens: torch.Tensor, *,
                collect_kv: bool = False, last_logit_only: bool = False,
                use_kernel: bool = True):
    """tokens: (B, S) -> dict(logits, hidden [, kv]).

    ``kv`` is ``{'0': {'k', 'v'}}`` with (n_periods, B, S, Hkv, Dh) leaves.
    last_logit_only: logits for the final position only.
    """
    _check_dense(cfg)
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    slot = params["slots"]["0"]
    ks, vs = [], []
    for i in range(cfg.n_periods):
        x, (k, v) = block_seq(_layer(slot, i), cfg, x, positions, use_kernel)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = common.rms_norm(params["final_norm"], x, cfg.norm_eps,
                        use_kernel=use_kernel)
    logits = common.linear(params["lm_head"],
                           x[:, -1:] if last_logit_only else x)
    out = {"logits": logits, "hidden": x}
    if collect_kv:
        out["kv"] = {"0": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return out


# ============================================================== decode mode
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device,
               dtype=torch.bfloat16):
    """Pre-allocated decode cache: (n_periods, B, C, Hkv, Dh) K and V."""
    _check_dense(cfg)
    shape = (cfg.n_periods, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"slots": {"0": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}},
        "pos": 0}


def block_decode(p, cfg: ModelConfig, x, k_cache, v_cache, pos: int):
    """One-token decode through one dense block; writes slot ``pos`` of
    ``k_cache``/``v_cache`` (B, C, Hkv, Dh) in place.  Returns x."""
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = common.rms_norm(p["ln1"], x, cfg.norm_eps)
    q = common.linear(p["attn"]["wq"], h).reshape(b, 1, hq, dh)
    k = common.linear(p["attn"]["wk"], h).reshape(b, 1, hkv, dh)
    v = common.linear(p["attn"]["wv"], h).reshape(b, 1, hkv, dh)
    posv = torch.full((1,), pos, device=x.device)
    q = common.apply_rope(q, posv, cfg.rope_theta)
    k = common.apply_rope(k, posv, cfg.rope_theta)
    idx = pos % k_cache.shape[1]
    k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos)
    x = x + common.linear(p["attn"]["wo"], o.reshape(b, 1, hq * dh))
    h2 = common.rms_norm(p["ln2"], x, cfg.norm_eps)
    return x + common.swiglu(p["mlp"], h2)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, token: torch.Tensor):
    """token: (B, 1) -> (logits (B, V), cache).

    The cache is updated in place (its K/V slot ``pos`` and ``pos``) and
    returned.
    """
    _check_dense(cfg)
    x = params["embed"][token]
    pos = cache["pos"]
    slot = params["slots"]["0"]
    kc, vc = cache["slots"]["0"]["k"], cache["slots"]["0"]["v"]
    for i in range(cfg.n_periods):
        x = block_decode(_layer(slot, i), cfg, x, kc[i], vc[i], pos)
    x = common.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = common.linear(params["lm_head"], x)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache


# ================================================================== prefill
@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None, cache_dtype=torch.bfloat16):
    """Run the sequence forward AND build a decode cache.

    Returns (logits (B, S, V), cache).  cache_len defaults to S.
    """
    b, s = tokens.shape
    cache_len = cache_len or s
    out = forward_seq(cfg, params, tokens, collect_kv=True)
    cache = init_cache(cfg, b, cache_len, device=tokens.device,
                       dtype=cache_dtype)
    take = min(s, cache_len)
    for name in ("k", "v"):
        cache["slots"]["0"][name][:, :, :take] = \
            out["kv"]["0"][name][:, :, -take:].to(cache_dtype)
    cache["pos"] = s
    return out["logits"], cache
