"""What a FIRM round needs, from the configuration and the traffic alone.

``matmul_params`` is N, the parameters a token multiplies by in one
forward: every projection, the MoE router and the top-k experts a token
is routed to, the LM head, and the shared attention block once for each
of its uses; not the embedding lookup, not the norms and not the SSM's
per-channel convolution.

A client-step of a round runs five forward-equivalents over its B rows
of S = P + T tokens: the generation (a prefill of P, then T decode
steps), the frozen reference's forward, the PPO forward, and M backward
pulls, each of which costs one forward in dX (the base is frozen) over
the layers from the first adapter on.  So ``round_flops`` is C K (3 + M)
2 N B S, less what the pulls do not reach, plus attention (4 Dh a kept
(query, key) pair and head forward, twice that a pull) and the SSD scan
(its chunked operations forward, twice them a pull, 4 nh hd ds a decode
token), over the layers a pull reaches.  Work the system adds (MoE
capacity padding, recomputation, logits the generation never reads) is
not counted.

``flash_calls`` and ``ssd_calls`` list the kernel calls a client-step
makes, with their shapes, for the rooflines.
"""
from __future__ import annotations

from firmbench.yardstick import costs

ATTN_KINDS = ("attn", "swa", "moe", "moe_swa", "shared_attn")
WINDOW_KINDS = ("swa", "moe_swa")


def _head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layer_kinds(cfg: dict) -> list:
    return [k for _ in range(cfg["n_periods"]) for k in cfg["pattern"]]


def _ssm(cfg: dict):
    din = cfg["ssm_expand"] * cfg["d_model"]
    return din, din // cfg["ssm_head_dim"], cfg["ssm_head_dim"], \
        cfg["ssm_state"]


def layer_params(cfg: dict, kind: str) -> int:
    d, dff = cfg["d_model"], cfg["d_ff"]
    if kind == "mamba2":
        din, nh, _, ds = _ssm(cfg)
        return d * (2 * din + 2 * ds + nh) + din * d
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], _head_dim(cfg)
    attn = 2 * d * hq * dh + 2 * d * hkv * dh
    if kind in ("moe", "moe_swa"):
        moe = cfg["moe"]
        return attn + 3 * d * dff * moe["top_k"] + d * moe["n_experts"]
    return attn + 3 * d * dff


def matmul_params(cfg: dict) -> int:
    return sum(layer_params(cfg, k) for k in layer_kinds(cfg)) + \
        cfg["d_model"] * cfg["vocab"]


def _first_trainable(cfg: dict) -> int:
    """Index of the first layer holding adapters (attention layers)."""
    kinds = layer_kinds(cfg)
    return next(i for i, k in enumerate(kinds) if k in ATTN_KINDS)


def _shape(traffic: dict):
    f = traffic["firm"]
    p, t = traffic["prompt_len"], traffic["max_new"]
    return (f["batch_size"], p, t, p + t, f["n_objectives"],
            f["n_clients"] * f["local_steps"])


def flash_calls(cfg: dict, traffic: dict) -> list:
    """(kind, args, kwargs) of the flash kernel calls of a client-step:
    prefill, reference forward and PPO forward of every attention layer,
    and M backward pulls of each."""
    b, p, _, s, m, _ = _shape(traffic)
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], _head_dim(cfg)
    calls = []
    for kind in layer_kinds(cfg):
        if kind not in ATTN_KINDS:
            continue
        w = cfg.get("sliding_window", 0) if kind in WINDOW_KINDS else 0
        kw = {"causal": True, "window": w}
        calls.append(("fwd", (b, p, p, hq, hkv, dh), kw))
        calls += [("fwd", (b, s, s, hq, hkv, dh), kw)] * 2
        calls += [("bwd", (b, s, s, hq, hkv, dh), kw)] * m
    return calls


def ssd_calls(cfg: dict, traffic: dict) -> list:
    """(kind, args, kwargs) of the SSD kernel calls of a client-step:
    prefill (with the final state), reference and PPO forwards of every
    Mamba2 layer, and M backward pulls of each layer after the first
    adapter."""
    b, p, _, s, m, _ = _shape(traffic)
    if not cfg.get("ssm_state"):
        return []
    _, nh, hd, ds = _ssm(cfg)
    chunk = cfg.get("ssm_chunk", 128)
    first = _first_trainable(cfg)
    calls = []
    for i, kind in enumerate(layer_kinds(cfg)):
        if kind != "mamba2":
            continue
        calls.append(("fwd", (b, p, nh, hd, ds),
                      {"chunk": chunk, "return_state": True}))
        calls += [("fwd", (b, s, nh, hd, ds), {"chunk": chunk})] * 2
        if i > first:
            calls += [("bwd", (b, s, nh, hd, ds), {"chunk": chunk})] * m
    return calls


def least_seconds(calls, kernel: str, peaks) -> float:
    """The least time the chip needs for ``calls`` of ``kernel``
    ('flash' or 'ssd'): the larger of operations over the peak rate and
    bytes over the memory bandwidth, call by call."""
    fns = {"flash": (costs.flash_attention, costs.flash_attention_bwd),
           "ssd": (costs.ssd, costs.ssd_bwd)}[kernel]
    total = 0.0
    for kind, args, kw in calls:
        nbytes, ops, peak = fns[kind == "bwd"](*args, **kw)
        total += max(ops / peaks.FLOPS[peak], nbytes / peaks.HBM_BYTES_S)
    return total


def client_step_flops(cfg: dict, traffic: dict) -> int:
    b, p, t, s, m, _ = _shape(traffic)
    hq, dh = cfg["n_heads"], _head_dim(cfg)
    first = _first_trainable(cfg)
    reached = sum(layer_params(cfg, k) for i, k in
                  enumerate(layer_kinds(cfg)) if i >= first) + \
        cfg["d_model"] * cfg["vocab"]
    total = 3 * 2 * matmul_params(cfg) * b * s + m * 2 * reached * b * s
    for i, kind in enumerate(layer_kinds(cfg)):
        pull = m if i >= first else 0
        if kind in ATTN_KINDS:
            w = cfg.get("sliding_window", 0) if kind in WINDOW_KINDS else 0
            full = costs.attention_pairs(s, s, True, w)
            decode = sum(min(p + 1 + j, w) if w else p + 1 + j
                         for j in range(t))
            pairs = costs.attention_pairs(p, p, True, w) + decode + \
                2 * full + 2 * pull * full
            total += 4 * dh * hq * b * pairs
        elif kind == "mamba2":
            _, nh, hd, ds = _ssm(cfg)
            chunk = cfg.get("ssm_chunk", 128)
            seq = costs.ssd_flops(b, s, nh, hd, ds, chunk)
            total += costs.ssd_flops(b, p, nh, hd, ds, chunk) + \
                4 * nh * hd * ds * b * t + 2 * seq + 2 * pull * seq
    return total


def round_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one round: C K client-steps."""
    return _shape(traffic)[5] * client_step_flops(cfg, traffic)
