"""The benchmark's frozen yardsticks: the copy of the kernels' bytes and
operations against the system's own table at today's shapes, and the
round's model FLOPs against a count by hand."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from firmbench.yardstick import costs, flops  # noqa: E402


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "model"]


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


FLASH = [  # (b, sq, skv, hq, hkv, dh, causal, window)
    (16, 1024, 1024, 32, 32, 64, True, 0),
    (16, 1072, 1072, 32, 32, 64, True, 0),
    (16, 512, 512, 32, 8, 128, True, 4096),
    (16, 256, 256, 32, 8, 128, True, 4096),
    (2, 40, 40, 4, 2, 16, True, 8),
]


@pytest.mark.parametrize("shape", FLASH)
@pytest.mark.parametrize("backward", [False, True])
def test_flash_costs_match_system(shape, backward):
    from repro_torch.kernels import costs as sys_costs
    b, sq, skv, hq, hkv, dh, causal, window = shape
    q = _meta((b, sq, hq, dh), torch.bfloat16)
    k = _meta((b, skv, hkv, dh), torch.bfloat16)
    name = "flash_attention_bwd" if backward else "flash_attention"
    want = sys_costs.COSTS[name](q, k, k, causal=causal,
                                 sliding_window=window)
    fn = costs.flash_attention_bwd if backward else costs.flash_attention
    assert fn(b, sq, skv, hq, hkv, dh, causal=causal, window=window) == want


SSD = [(16, 1024, 64, 64, 64, 128), (16, 1072, 64, 64, 64, 128),
       (16, 512, 64, 64, 64, 128), (3, 37, 4, 16, 16, 8)]


@pytest.mark.parametrize("shape", SSD)
@pytest.mark.parametrize("kind", ["fwd", "fwd_state", "bwd"])
def test_ssd_costs_match_system(shape, kind):
    from repro_torch.kernels import costs as sys_costs
    b, s, nh, hd, ds, chunk = shape
    x = _meta((b, s, nh, hd), torch.float32)
    bm = _meta((b, s, ds), torch.float32)
    dt = _meta((b, s, nh), torch.float32)
    if kind == "bwd":
        want = sys_costs.COSTS["ssd_bwd"](x, bm, bm, dt, dt, chunk=chunk)
        assert costs.ssd_bwd(b, s, nh, hd, ds, chunk=chunk) == want
    else:
        st = kind == "fwd_state"
        want = sys_costs.COSTS["ssd"](x, bm, bm, dt, dt, chunk=chunk,
                                      return_state=st)
        assert costs.ssd(b, s, nh, hd, ds, chunk=chunk,
                         return_state=st) == want


def test_matmul_params_by_hand():
    # zamba2: 32 Mamba2 (in_proj 2048 x 8384, out_proj 4096 x 2048), the
    # shared block used 6 times (4 x 2048^2 + 3 x 2048 x 8192), LM head
    mamba = 2048 * 8384 + 4096 * 2048
    shared = 4 * 2048 * 2048 + 3 * 2048 * 8192
    assert flops.matmul_params(_cfg("zamba2-1.2b")) == \
        32 * mamba + 6 * shared + 2048 * 32000 == 1_286_078_464
    # mixtral stage: 4 layers of q, o (4096^2), k, v (4096 x 1024), the
    # router (4096 x 8) and 2 of 8 experts (3 x 4096 x 14336), LM head
    layer = 2 * 4096 ** 2 + 2 * 4096 * 1024 + 4096 * 8 + \
        2 * 3 * 4096 * 14336
    assert flops.matmul_params(_cfg("mixtral-8x7b")) == \
        4 * layer + 4096 * 32000 == 1_708_261_376


def test_round_flops_by_hand():
    """A one-layer attention model and a one-layer Mamba2-then-attention
    model, B = 2, P = 3, T = 2, M = 2, C K = 2, counted by hand."""
    tr = {"prompt_len": 3, "max_new": 2,
          "firm": {"batch_size": 2, "n_objectives": 2, "n_clients": 2,
                   "local_steps": 1}}
    cfg = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
           "d_ff": 16, "vocab": 10, "pattern": ["attn"], "n_periods": 1}
    n = 2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16 + 8 * 10        # 640
    s = 5
    pairs = (3 * 4 // 2) + (4 + 5) + 2 * (5 * 6 // 2) * (1 + 2)
    want = 2 * (5 * 2 * n * 2 * s + 4 * 4 * 2 * 2 * pairs)
    assert flops.round_flops(cfg, tr) == want
    cfg2 = dict(cfg, pattern=["mamba2", "attn"], ssm_expand=2,
                ssm_head_dim=4, ssm_state=2, ssm_chunk=4)
    din, nh, hd, ds = 16, 4, 4, 2
    mamba = 8 * (2 * din + 2 * ds + nh) + din * 8
    seq = flops.costs.ssd_flops(2, s, nh, hd, ds, 4)
    # the pulls stop at the attention layer: the Mamba2 layer before it
    # gets three forwards and no backward
    want2 = 2 * (3 * 2 * (n + mamba) * 2 * s + 2 * 2 * n * 2 * s
                 + 4 * 4 * 2 * 2 * pairs
                 + flops.costs.ssd_flops(2, 3, nh, hd, ds, 4)
                 + 4 * nh * hd * ds * 2 * 2 + 2 * seq)
    assert flops.round_flops(cfg2, tr) == want2


def test_kernel_calls_of_a_round():
    """Six flash calls a shared-attention use and client-step (prefill,
    two forwards, two pulls), and SSD backward only after the first
    adapter."""
    cfg, tr = _cfg("zamba2-1.2b"), _traffic("long_prompt")
    calls = flops.flash_calls(cfg, tr)
    assert len(calls) == 6 * 5
    assert sum(k == "bwd" for k, _, _ in calls) == 6 * 2
    ssd = flops.ssd_calls(cfg, tr)
    assert sum(k == "fwd" for k, _, _ in ssd) == 32 * 3
    assert sum(k == "bwd" for k, _, _ in ssd) == 27 * 2
    assert flops.ssd_calls(_cfg("mixtral-8x7b"), tr) == []
