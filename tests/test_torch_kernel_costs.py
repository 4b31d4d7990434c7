"""``kernels/costs.py`` against the bytes and operations each kernel's
bound was computed from before the costs had a module of their own.

Each case writes the earlier formula out at the shape ``chip_smoke.py``
runs the kernel at (the rollout's B = 16, S = 256; head_dim 128; the
whisper encoder and the vision cross shapes; prefill at S = 32768; the
round's 3,407,872 trainables of two clients; zamba2's SSD), on ``meta``
tensors, so nothing is allocated.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import costs

BF16, F32 = torch.bfloat16, torch.float32
D_LORA, C, BLOCK = 3_407_872, 2, 1024
ROWS = C * -(-D_LORA // BLOCK)            # the round's quantized rows


def t(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def nb(*ts) -> int:
    return sum(x.numel() * x.element_size() for x in ts)


def flash_case(b, sq, skv, hq, hkv, dh, causal):
    q, k, v = t(b, sq, hq, dh, dtype=BF16), t(b, skv, hkv, dh, dtype=BF16), \
        t(b, skv, hkv, dh, dtype=BF16)
    pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * skv)
    fwd = (costs.flash_attention(q, k, v, causal=causal),
           (nb(q, k, v, q), 4 * dh * pairs, "bf16"))
    # inputs q, k, v, o, dO, lse; outputs dq, dk, dv (o, dO, dq like q)
    bwd = (costs.flash_attention_bwd(q, k, v, causal=causal),
           (nb(q, k, v, q, q) + 4 * b * hq * sq + nb(q, k, v),
            10 * dh * pairs, "bf16"))
    return fwd, bwd


FLASH_SHAPES = {
    "main": (16, 256, 256, 32, 8, 64, True),
    "dh128": (16, 256, 256, 32, 8, 128, True),
    "whisper_enc": (16, 1500, 1500, 20, 20, 64, False),
    "vision_cross": (16, 256, 1601, 64, 8, 128, False),
    "prefill_32k": (1, 32768, 32768, 32, 8, 64, True),
}


def _cases():
    out = {}
    for tag, shape in FLASH_SHAPES.items():
        out[f"flash_attention[{tag}]"], out[f"flash_attention_bwd[{tag}]"] = \
            flash_case(*shape)
    x, g = t(4096, 2048, dtype=BF16), t(2048, dtype=BF16)
    out["rmsnorm"] = (costs.rmsnorm(x, g),
                      (2 * nb(x) + nb(g), 4 * x.numel(), "f32"))
    out["rmsnorm_bwd"] = (costs.rmsnorm_bwd(x, g),
                          (3 * nb(x) + 2048 * 2, 10 * x.numel(), "f32"))
    xd, gd = t(4096, 768, dtype=BF16), t(768, dtype=BF16)
    out["rmsnorm_bwd[dg]"] = (costs.rmsnorm_bwd(xd, gd, want_dg=True),
                              (3 * nb(xd) + 2 * 768 * 2, 22 * xd.numel(),
                               "f32"))
    xs = t(2, D_LORA)
    out["gram"] = (costs.gram(xs), (xs.numel() * 4 + 2 * 2 * 4,
                                    2 * 2 * 2 * D_LORA, "f32"))
    n_el = ROWS * BLOCK
    x2, bits = t(ROWS, BLOCK), t(ROWS, BLOCK, dtype=torch.int32)
    out["quantize"] = (costs.quantize(x2, bits),
                       (8 * n_el + n_el + 4 * ROWS, 9 * n_el, "f32"))
    codes, scales = t(ROWS, BLOCK, dtype=torch.int8), t(ROWS)
    out["dequantize"] = (costs.dequantize(codes, scales, x2),
                         (n_el + 4 * ROWS + 4 * n_el + 8 * n_el, 3 * n_el,
                          "f32"))
    out["dequantize[no residual]"] = (costs.dequantize(codes, scales),
                                      (n_el + 4 * ROWS + 4 * n_el, n_el,
                                       "f32"))
    x_topk, thresh = t(C, ROWS // C, BLOCK), t(C)
    out["abs_threshold_count"] = (costs.abs_threshold_count(x_topk, thresh),
                                  (4 * n_el + 8 * C, 2 * n_el, "f32"))
    out["abs_threshold_mask"] = (costs.abs_threshold_mask(x_topk, thresh),
                                 (8 * n_el + 4 * C, 2 * n_el, "f32"))
    # zamba2's SSD at the rollout's (16, 256), 64 heads of 64, state 64
    b, s, nh, hd, ds = 16, 256, 64, 64, 64
    ssd_in = (t(b, s, nh, hd), t(b, s, ds), t(b, s, ds), t(b, s, nh),
              t(b, s, nh))
    out["ssd"] = (costs.ssd(*ssd_in, return_state=True),
                  (4 * (2 * b * s * nh * hd + 2 * b * s * ds + 2 * b * s * nh
                        + b * nh * hd * ds), 6_493_044_736, "tf32"))
    out["ssd_bwd"] = (costs.ssd_bwd(*ssd_in),
                      (4 * (3 * b * s * nh * hd + 4 * b * s * ds
                            + 4 * b * s * nh), 15_167_389_696, "tf32"))
    return out


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_cost_equals_the_earlier_bound_formula(name):
    got, want = CASES[name]
    assert got == want


def test_every_kernel_has_a_pinned_case():
    pinned = {name.split("[")[0] for name in CASES}
    assert pinned == set(costs.COSTS)


def test_ssd_formulas_match_the_published_bounds():
    """The SSD's bytes as PERF.md's bounds state them (155,189,248 and
    209,715,200 at zamba2's rollout shape)."""
    assert CASES["ssd"][0][0] == 155_189_248
    assert CASES["ssd_bwd"][0][0] == 209_715_200
