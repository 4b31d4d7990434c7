"""The benchmark's weights: the parameter layout of a configuration and
its values, drawn from the run's seed on the device.

``layout`` lists every parameter (its path, shape and dtype) from the
configuration's sizes alone, in the system's parameter tree: ``embed``,
``final_norm.g``, ``lm_head.w``, ``slots.<i>.<...>`` (the pattern slot's
block, stacked over the periods on the leading axis) and ``shared`` (the
one shared attention block).  Base weights are bf16, the MoE router, the
LoRA factors and the SSM's per-head vectors float32.

``make`` draws all of a dtype's random values in one call on the device
and hands out views of that buffer, scaled in place: a matrix N(0,
1/fan_in), the embedding N(0, 0.02^2), the depthwise convolution N(0,
1/K^2); norms and the SSM's D one, ``lora_B``, the biases and ``dt_bias``
zero, ``A_log`` log(linspace(1, 16, heads)).
"""
from __future__ import annotations

import math

import torch

BF16, F32 = torch.bfloat16, torch.float32


def _attn(cfg: dict, lead: tuple) -> dict:
    d, hq, hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("head_dim") or d // hq
    rank = cfg["lora"]["rank"] if cfg.get("lora") else 0
    out = {}
    for name, din, dout in (("wq", d, hq * dh), ("wk", d, hkv * dh),
                            ("wv", d, hkv * dh), ("wo", hq * dh, d)):
        out[name] = {"w": (lead + (din, dout), BF16)}
        if rank:
            out[name]["lora_A"] = (lead + (din, rank), F32)
            out[name]["lora_B"] = (lead + (rank, dout), F32)
    return out


def _block(kind: str, cfg: dict, lead: tuple) -> dict:
    d, dff = cfg["d_model"], cfg["d_ff"]
    if kind == "mamba2":
        din = cfg["ssm_expand"] * d
        nh, ds = din // cfg["ssm_head_dim"], cfg["ssm_state"]
        ch = din + 2 * ds
        return {"ln": {"g": (lead + (d,), BF16)},
                "in_proj": {"w": (lead + (d, 2 * din + 2 * ds + nh), BF16)},
                "conv_w": (lead + (cfg["conv_dim"], ch), BF16),
                "conv_b": (lead + (ch,), BF16),
                "A_log": (lead + (nh,), F32), "D": (lead + (nh,), F32),
                "dt_bias": (lead + (nh,), F32),
                "out_proj": {"w": (lead + (din, d), BF16)}}
    p = {"ln1": {"g": (lead + (d,), BF16)}, "attn": _attn(cfg, lead),
         "ln2": {"g": (lead + (d,), BF16)}}
    if kind in ("moe", "moe_swa"):
        e = cfg["moe"]["n_experts"]
        p["moe"] = {"router": {"w": (lead + (d, e), F32)},
                    "experts": {"w_gate": (lead + (e, d, dff), BF16),
                                "w_up": (lead + (e, d, dff), BF16),
                                "w_down": (lead + (e, dff, d), BF16)}}
    else:
        p["mlp"] = {"w_gate": {"w": (lead + (d, dff), BF16)},
                    "w_up": {"w": (lead + (d, dff), BF16)},
                    "w_down": {"w": (lead + (dff, d), BF16)}}
    return p


def layout(cfg: dict) -> dict:
    """The parameter tree of ``cfg`` with (shape, dtype) leaves."""
    d, v = cfg["d_model"], cfg["vocab"]
    tree = {"embed": ((v, d), BF16), "final_norm": {"g": ((d,), BF16)},
            "lm_head": {"w": ((d, v), BF16)},
            "slots": {str(i): _block(kind, cfg, (cfg["n_periods"],))
                      for i, kind in enumerate(cfg["pattern"])
                      if kind != "shared_attn"}}
    if "shared_attn" in cfg["pattern"]:
        tree["shared"] = _block("shared_attn", cfg, ())
    return tree


def leaves(tree, path=()):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in leaves(tree[k],
                                                           path + (k,))]
    return [(path, tree)]


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _fill(path, t: torch.Tensor) -> None:
    """Scale a view of standard normal draws in place, or overwrite it."""
    name = path[-1]
    if name in ("g", "D"):
        t.fill_(1.0)
    elif name in ("lora_B", "conv_b", "dt_bias"):
        t.zero_()
    elif name == "A_log":
        nh = t.shape[-1]
        t.copy_(torch.log(torch.linspace(1.0, 16.0, nh, device=t.device))
                .expand(t.shape))
    elif name == "embed":
        t.mul_(0.02)
    elif name == "conv_w":
        t.mul_(1.0 / t.shape[-2])
    else:                       # a matrix, a stack of experts, lora_A
        t.mul_(1.0 / math.sqrt(t.shape[-2]))


def make(cfg: dict, seed: int, device, base_dtype=BF16) -> dict:
    """The weights of ``cfg`` drawn from ``seed`` on ``device``: one normal
    draw a dtype, carved into the leaves.  ``base_dtype`` float32 (for
    the CPU tests) makes the bf16 leaves float32."""
    items = [(p, (shape, base_dtype if dt == BF16 else dt))
             for p, (shape, dt) in leaves(layout(cfg))]
    out: dict = {}
    for dtype in sorted({dt for _, (_, dt) in items}, key=str):
        mine = [(p, shape) for p, (shape, dt) in items if dt == dtype]
        if not mine:
            continue
        total = sum(math.prod(shape) for _, shape in mine)
        g = torch.Generator(device=device).manual_seed(
            (int(seed) * 2 + (dtype == F32)) % 2 ** 63)
        buf = torch.randn(total, generator=g, device=device, dtype=dtype)
        off = 0
        for path, shape in mine:
            n = math.prod(shape)
            view = buf[off:off + n].view(shape)
            _fill(path, view)
            _set(out, path, view)
            off += n
    return out

