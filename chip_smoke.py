#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--stop-after PHASE]

Phases, in order; any failure raises and the script exits non-zero
(``--stop-after`` ends the run after the named phase, with no result
line, for a first check of new kernels):

1. device:  the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build:   one ``nvcc`` for each source of ``src/repro_torch/kernels/csrc``,
            all started together, then one link.
3. rmsnorm: the CUDA kernel against its plain PyTorch version at the
            rollout's shapes, then timed beside ``F.rms_norm``.
4. flash:   the CUDA flash-attention kernel against its plain version
            (causal, ragged, non-causal, sliding window, f32), then timed
            beside ``F.scaled_dot_product_attention``.
5. gram:    the CUDA Gram kernel against its plain version at the local
            step's shape (2, 3,407,872) f32 and off it (M = 3 and 8, ragged
            d, bf16, a misaligned row), twice for the same bits, then timed
            beside ``X @ X.T``.
6. rmsnorm_bwd, 7. flash_bwd: the backward kernels against their plain
            versions (autograd of the plain forward) at the local step's
            shapes and off them (the forwards' extra cases), then timed
            beside the backward of ``F.rms_norm`` and of SDPA.
8. rollout: ``fed.engine.rollout_batch`` on llama-3.2-1b at full width
            (random weights from a seeded generator): 16 prompts of 128
            tokens, 128 new tokens, 2 objectives.  The kernels' launch counts
            are zeroed just before it and must be exactly 4290 (rmsnorm)
            and 32 (flash attention), and 0 for the others, just after.  The
            outputs are checked, and a teacher-forced bf16 forward through
            the kernels must agree with the plain bf16 forward within 2e-2
            of the logits' scale and be as close to the f32 forward as the
            plain one is.  Then, uncounted: the rollout's steps timed one by
            one, and 8 decode steps under ``torch.profiler`` for the
            device's idle share.
9. local_step: ``fed.engine.client_local_steps`` on the same model, one
            client, K=2 local steps of B=16 prompts (each a rollout, then
            ``firm_local_step`` with FIRMConfig's defaults).  The counts are
            zeroed just before it and must be exact just after.  Then,
            uncounted: one ``firm_local_step`` on the rollout phase's batch
            (lambda on the simplex, finite losses, lora_A gradients exactly
            0 while lora_B = 0, adapters and counters moved), its time by
            part, peak memory and device idle share, and the M gradients
            through the kernels, through the plain versions and through an
            f32 copy of the model.
10. serve:  the ``launch.serve`` CLI at full width, a few tokens.

Every number is printed as JSON on a line of its own; the second-to-last
line holds the per-kernel table and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (dense): HBM bytes/s, FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

B, P, MAX_NEW, N_OBJ = 16, 128, 128, 2


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


PHASES = ("device", "build", "rmsnorm", "flash", "gram", "rmsnorm_bwd",
          "flash_bwd", "rollout", "local_step", "serve")


class StopAfter(Exception):
    """Raised to end the run after the phase named by --stop-after."""


def main(argv=None) -> int:
    import torch

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--stop-after", choices=PHASES, default=None)
    stop_after = args.parse_args(argv).stop_after
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        return run(torch, stop_after)
    except StopAfter:
        print(f"chip_smoke: stopped after {stop_after}; no result",
              file=sys.stderr)
        return 3


def run(torch, stop_after) -> int:
    def done(phase: str) -> None:
        if phase == stop_after:
            raise StopAfter(phase)

    from repro_torch.configs import FIRMConfig, get_config
    from repro_torch.core import firm
    from repro_torch.data.partition import make_client_datasets
    from repro_torch.fed.engine import client_local_steps, rollout_batch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import gram as gram_mod
    from repro_torch.kernels import rmsnorm as rn_mod
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.rlhf import critic, local, ppo, rewards
    from repro_torch.rlhf.sampling import generate
    from repro_torch.train import optim

    dev = torch.device("cuda")
    F = torch.nn.functional

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # device clock cycles per ms of torch.cuda._sleep, measured once
    start, end = events()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    sleep_cycles_per_ms = 10_000_000 / start.elapsed_time(end)

    def timed_ms(fn, iters: int = 50, warmup: int = 5,
                 hold: bool = True) -> float:
        """Mean device time of ``fn`` over ``iters`` back-to-back calls.

        With ``hold``, a sleep kernel holds the stream while the host
        queues the calls, so the events time the device alone and not the
        host's cost per launch, which exceeds a short kernel's run time;
        the sleep is lengthened until it outlasts the queueing.
        """
        for _ in range(warmup):
            fn()
        sleep_ms = 20.0
        while True:
            torch.cuda.synchronize()
            start, end = events()
            if hold:
                torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms))
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if not hold or queued_ms < sleep_ms:
                return start.elapsed_time(end) / iters
            sleep_ms *= 4

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def device_profile(fn, steps: int):
        """Device busy and idle share of ``fn`` under torch.profiler; the
        window runs from the first kernel's start to the last one's end.
        None ("not measured") when the trace holds no device time."""
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            return None
        busy = sum(e.time_range.elapsed_us() for e in kernels)
        window = (max(e.time_range.end for e in kernels)
                  - min(e.time_range.start for e in kernels))
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return {"steps": steps, "kernels_per_step": len(kernels) / steps,
                "device_busy_us_per_step": busy / steps,
                "window_us_per_step": window / steps,
                "device_idle_share": 1 - busy / window,
                "top_kernels_us_per_step": {n: t / steps for n, t in top}}

    counters = {"rmsnorm": (rn_mod, "launches"),
                "rmsnorm_bwd": (rn_mod, "bwd_launches"),
                "flash_attention": (fa_mod, "launches"),
                "flash_attention_bwd": (fa_mod, "bwd_launches"),
                "gram": (gram_mod, "launches")}

    def zero_counts() -> None:
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts() -> dict:
        return {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}

    # ------------------------------------------------------------ 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit(phase="device", name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    done("device")

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             lib_path.with_suffix(".log").read_text().splitlines()
             if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
    emit(phase="build", seconds=build_s, library=str(lib_path.name),
         ptxas=ptxas)
    done("build")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ----------------------------------------------------------- 3. rmsnorm
    def bf16_ulps(a, b) -> int:
        """Largest distance between two bf16 tensors in units in the last
        place (bit patterns mapped to a monotonic integer scale)."""
        def key(t):
            bits = t.contiguous().view(torch.int16).int()
            return torch.where(bits < 0, -(bits & 0x7FFF), bits)
        return int((key(a) - key(b)).abs().max())

    # bf16: the normalised row (g = 1) may differ from the plain version's
    # by 1 ulp (f32 reduction order and rsqrtf); scaled by g, such a flip
    # spans less than 2 ulps of the product, so the output is held to 2.
    # The last three cases take the kernel's scalar path: a width that is
    # no multiple of 16 bytes, or a row that starts off a 16-byte boundary.
    d = 2048
    rms_cases = [((4096, d), torch.bfloat16, False, 0),
                 ((4096, d), torch.bfloat16, True, 0),
                 ((B, d), torch.bfloat16, False, 0),
                 ((3, d), torch.float32, False, 0),
                 ((1, 1001), torch.bfloat16, False, 0),
                 ((5, 2050), torch.float32, False, 0),
                 ((7, d), torch.bfloat16, False, 1)]
    rms_err = {}
    for shape, dtype, unit_g, offset in rms_cases:
        n = shape[0] * shape[1]
        x = randn((n + offset,), dtype)[offset:].view(shape)
        g = (torch.ones(shape[-1:], device=dev, dtype=dtype) if unit_g
             else randn(shape[-1:], dtype))
        got, want = rn_mod.rmsnorm(x, g), ref.rmsnorm(x, g)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        label = (f"{shape}{' g=1' if unit_g else ''}"
                 f"{' misaligned' if offset else ''}")
        if dtype == torch.bfloat16:
            ulps, limit = bf16_ulps(got, want), 1 if unit_g else 2
            check(ulps <= limit, f"rmsnorm {label} bf16 off by {ulps} ulp")
            rms_err[label] = {"max_abs": err, "max_ulps": ulps}
        else:
            rel = float(((got - want).abs()
                         / (want.abs() + 1e-6)).max())
            check(rel <= 1e-5, f"rmsnorm {shape} f32 rel err {rel}")
            rms_err[label] = {"max_abs": err, "max_rel": rel}
    x, g = randn((4096, d), torch.bfloat16), randn((d,), torch.bfloat16)
    rms_row = {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:41",
        "max_abs_err": rms_err[str((4096, d))]["max_abs"],
        "ms": timed_ms(lambda: rn_mod.rmsnorm(x, g)),
        "plain_ms": timed_ms(lambda: ref.rmsnorm(x, g)),
        "library_ms": timed_ms(lambda: F.rms_norm(x, (d,), g, 1e-5)),
        # the same loop paced by the host's launches, for comparison
        "ms_without_hold": timed_ms(lambda: rn_mod.rmsnorm(x, g),
                                    hold=False),
    }
    n_bytes = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
    rms_row["bound_ms"], rms_row["bound_by"] = bound_ms(
        n_bytes, 4 * x.numel(), "f32")
    emit(phase="rmsnorm", shape=[4096, d], dtype="bf16", checks=rms_err,
         tolerance="bf16: normalised row (g=1) <= 1 ulp, output <= 2 ulp; "
         "f32: 1e-5 relative", **rms_row)
    done("rmsnorm")

    # ------------------------------------------------------------- 4. flash
    def qkv(b, sq, skv, hq, hkv, dh, dtype):
        return (randn((b, sq, hq, dh), dtype),
                randn((b, skv, hkv, dh), dtype),
                randn((b, skv, hkv, dh), dtype))

    # (b, sq, skv, hq, hkv, dh); the last four cases cover the other head
    # dims the kernel is built for and query and key lengths that differ
    flash_cases = [
        ("rollout S=256 causal", (B, 256, 256, 32, 8, 64), torch.bfloat16,
         True, 0),
        ("prefill S=128 causal", (B, P, P, 32, 8, 64), torch.bfloat16, True,
         0),
        ("ragged S=77 causal", (2, 77, 77, 32, 8, 64), torch.bfloat16, True,
         0),
        ("non-causal S=256", (2, 256, 256, 32, 8, 64), torch.bfloat16, False,
         0),
        ("window 64 S=256", (2, 256, 256, 32, 8, 64), torch.bfloat16, True,
         64),
        ("f32 ragged S=100", (2, 100, 100, 32, 8, 64), torch.float32, True,
         0),
        ("dh=32 S=40 causal", (2, 40, 40, 8, 2, 32), torch.bfloat16, True, 0),
        ("dh=16 f32 S=33 causal", (2, 33, 33, 4, 1, 16), torch.float32, True,
         0),
        ("Sq=50 Skv=130 non-causal", (2, 50, 130, 32, 8, 64), torch.bfloat16,
         False, 0),
        ("Sq=130 Skv=50 causal", (2, 130, 50, 32, 8, 64), torch.bfloat16,
         True, 0),
    ]
    flash_err = {}
    for label, (b, sq, skv, hq, hkv, dh), dtype, causal, window in \
            flash_cases:
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype)
        got = fa_mod.flash_attention(q, k, v, causal=causal,
                                     sliding_window=window)
        want = ref.flash_attention(q, k, v, causal=causal,
                                   sliding_window=window)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= tol + tol * want.float().abs()).all())
        flash_err[label] = float(diff.max())
        check(ok, f"flash attention {label}: max abs err {float(diff.max())}")
    s = 256
    q, k, v = qkv(B, s, s, 32, 8, 64, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98",
        "max_abs_err": flash_err["rollout S=256 causal"],
        "ms": timed_ms(lambda: fa_mod.flash_attention(q, k, v, causal=True)),
        "plain_ms": timed_ms(lambda: ref.flash_attention(q, k, v,
                                                         causal=True),
                             iters=10),
        "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
    }
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    pairs = B * 32 * s * (s + 1) // 2          # causal (query, key) pairs
    flash_row["bound_ms"], flash_row["bound_by"] = bound_ms(
        n_bytes, 4 * 64 * pairs, "bf16")
    emit(phase="flash", shape=[B, s, 32, 8, 64], dtype="bf16", causal=True,
         checks=flash_err, tolerance="2e-2 bf16, 2e-4 f32 (atol and rtol)",
         **flash_row)
    done("flash")

    # -------------------------------------------------------------- 5. gram
    cfg = get_config("llama-3.2-1b")
    r_lora = cfg.lora.rank
    dq_w, dkv_w = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    # LoRA parameters of wq, wk, wv, wo over all layers: the row width of
    # the local step's (M, d) gradient matrix
    d_lora = cfg.n_periods * r_lora * (2 * (cfg.d_model + dq_w)
                                       + 2 * (cfg.d_model + dkv_w))

    def max_rel(got, want) -> float:
        """Largest error relative to the compared tensor's scale."""
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    # sums over d in another order than cuBLAS's: 1e-5 of G's scale
    gram_cases = [((N_OBJ, d_lora), torch.float32, 0),
                  ((N_OBJ, d_lora), torch.bfloat16, 0),
                  ((3, 1000), torch.float32, 0),
                  ((8, 8193), torch.float32, 0),
                  ((3, 8193), torch.bfloat16, 0),
                  ((8, 1000), torch.bfloat16, 0),
                  ((2, 4096), torch.float32, 1)]
    gram_err = {}
    for (m_, d_), dtype, offset in gram_cases:
        x = randn((m_ * d_ + offset,), dtype)[offset:].view(m_, d_)
        got, again = gram_mod.gram(x), gram_mod.gram(x)
        want = ref.gram(x)
        torch.cuda.synchronize()
        label = (f"({m_}, {d_}) {str(dtype)[6:]}"
                 f"{' misaligned' if offset else ''}")
        gram_err[label] = max_rel(got, want)
        check(gram_err[label] <= 1e-5, f"gram {label}: rel err "
              f"{gram_err[label]}")
        check(torch.equal(got, again), f"gram {label}: not the same bits "
              "twice")
    x = randn((N_OBJ, d_lora), torch.float32)
    gram_row = {
        "name": "gram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram.py:43",
        "max_abs_err": float((gram_mod.gram(x) - ref.gram(x)).abs().max()),
        "ms": timed_ms(lambda: gram_mod.gram(x)),
        "plain_ms": timed_ms(lambda: ref.gram(x)),
        "library_ms": timed_ms(lambda: x @ x.T),
    }
    gram_row["bound_ms"], gram_row["bound_by"] = bound_ms(
        x.numel() * 4 + N_OBJ * N_OBJ * 4, 2 * N_OBJ * N_OBJ * d_lora, "f32")
    emit(phase="gram", shape=[N_OBJ, d_lora], dtype="f32",
         checks=gram_err, same_bits_twice=True,
         tolerance="max |G - plain| <= 1e-5 max |plain| (sum order); the "
         "same bits on two runs", **gram_row)
    done("gram")

    # ------------------------------------------------------- 6. rmsnorm_bwd
    # bf16: dx is rounded once from f32 on both sides, after reductions in
    # another order, so it may differ by an ulp: 2e-2 of dx's scale.  f32:
    # 1e-4 of the scale.  The last three cases take the scalar path.
    def bwd_tol(dtype) -> float:
        return 2e-2 if dtype == torch.bfloat16 else 1e-4

    rms_bwd_err = {}
    for shape, dtype, offset in [((4096, d), torch.bfloat16, 0),
                                 ((4096, d), torch.float32, 0),
                                 ((B, d), torch.bfloat16, 0),
                                 ((1, 1001), torch.bfloat16, 0),
                                 ((5, 2050), torch.float32, 0),
                                 ((7, d), torch.bfloat16, 1)]:
        n = shape[0] * shape[1]
        x = randn((n + offset,), dtype)[offset:].view(shape)
        g, dy = randn(shape[-1:], dtype), randn(shape, dtype)
        got, want = rn_mod.rmsnorm_bwd(x, g, dy), ref.rmsnorm_bwd(x, g, dy)
        torch.cuda.synchronize()
        label = (f"{shape} {str(dtype)[6:]}"
                 f"{' misaligned' if offset else ''}")
        rms_bwd_err[label] = max_rel(got, want)
        check(rms_bwd_err[label] <= bwd_tol(dtype),
              f"rmsnorm_bwd {label}: rel err {rms_bwd_err[label]}")
    x, g, dy = (randn((4096, d), torch.bfloat16),
                randn((d,), torch.bfloat16), randn((4096, d), torch.bfloat16))
    xl = x.detach().requires_grad_()
    yl = F.rms_norm(xl, (d,), g, 1e-5)
    rms_bwd_row = {
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:41 (its gradient)",
        "max_abs_err": float((rn_mod.rmsnorm_bwd(x, g, dy)
                              - ref.rmsnorm_bwd(x, g, dy)).abs().max()),
        "ms": timed_ms(lambda: rn_mod.rmsnorm_bwd(x, g, dy)),
        "plain_ms": timed_ms(lambda: ref.rmsnorm_bwd(x, g, dy)),
        "library_ms": timed_ms(lambda: torch.autograd.grad(
            yl, xl, dy, retain_graph=True)),
    }
    rms_bwd_row["bound_ms"], rms_bwd_row["bound_by"] = bound_ms(
        3 * x.numel() * x.element_size() + d * 2, 10 * x.numel(), "f32")
    del xl, yl
    emit(phase="rmsnorm_bwd", shape=[4096, d], dtype="bf16",
         checks=rms_bwd_err, tolerance="max |dx - plain| <= 2e-2 (bf16) or "
         "1e-4 (f32) of max |plain|", **rms_bwd_row)
    done("rmsnorm_bwd")

    # --------------------------------------------------------- 7. flash_bwd
    flash_bwd_err = {}
    for label, (b, sq, skv, hq, hkv, dh), dtype, causal, window in [
            ("local step S=256 causal", (B, 256, 256, 32, 8, 64),
             torch.bfloat16, True, 0),
            ("ragged S=77 causal", (2, 77, 77, 32, 8, 64), torch.bfloat16,
             True, 0),
            ("non-causal S=256", (2, 256, 256, 32, 8, 64), torch.bfloat16,
             False, 0),
            ("window 64 S=256", (2, 256, 256, 32, 8, 64), torch.bfloat16,
             True, 64),
            ("f32 ragged S=100", (2, 100, 100, 32, 8, 64), torch.float32,
             True, 0),
            ("dh=32 S=40 causal", (2, 40, 40, 8, 2, 32), torch.bfloat16,
             True, 0),
            ("dh=16 f32 S=33 causal", (2, 33, 33, 4, 1, 16), torch.float32,
             True, 0),
            ("Sq=50 Skv=130 non-causal", (2, 50, 130, 32, 8, 64),
             torch.bfloat16, False, 0),
            ("Sq=130 Skv=50 causal", (2, 130, 50, 32, 8, 64),
             torch.bfloat16, True, 0)]:
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype)
        do = randn((b, sq, hq, dh), dtype)
        o, lse = fa_mod.flash_attention_fwd(q, k, v, causal=causal,
                                            sliding_window=window,
                                            with_lse=True)
        got = fa_mod.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         sliding_window=window)
        want = ref.flash_attention_bwd(q, k, v, do, causal=causal,
                                       sliding_window=window)
        torch.cuda.synchronize()
        errs = {name: max_rel(a, w_) for name, a, w_ in zip(
            ("dq", "dk", "dv"), got, want)}
        flash_bwd_err[label] = errs
        check(max(errs.values()) <= bwd_tol(dtype),
              f"flash_attention_bwd {label}: rel errs {errs}")
    q, k, v = qkv(B, s, s, 32, 8, 64, torch.bfloat16)
    do = randn((B, s, 32, 64), torch.bfloat16)
    o, lse = fa_mod.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot_ = do.transpose(1, 2)
    flash_bwd_row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98 (its gradient)",
        "max_abs_err": max(
            float((a.float() - w_.float()).abs().max()) for a, w_ in zip(
                fa_mod.flash_attention_bwd(q, k, v, o, lse, do),
                ref.flash_attention_bwd(q, k, v, do))),
        "ms": timed_ms(lambda: fa_mod.flash_attention_bwd(q, k, v, o, lse,
                                                          do)),
        "plain_ms": timed_ms(lambda: ref.flash_attention_bwd(q, k, v, do),
                             iters=10),
        "library_ms": timed_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot_, retain_graph=True)),
    }
    # inputs q, k, v, o, dO, lse; outputs dq, dk, dv; 10 Dh flops per kept
    # (query, key) pair: 2 Dh each for S, dP, dV, dQ and dK
    n_bytes = (sum(t.numel() * t.element_size() for t in (q, k, v, o, do))
               + lse.numel() * 4
               + sum(t.numel() * t.element_size() for t in (q, k, v)))
    flash_bwd_row["bound_ms"], flash_bwd_row["bound_by"] = bound_ms(
        n_bytes, 10 * 64 * pairs, "bf16")
    del qt, kt, vt, ot
    emit(phase="flash_bwd", shape=[B, s, 32, 8, 64], dtype="bf16",
         causal=True, checks=flash_bwd_err,
         tolerance="max |d - plain| <= 2e-2 (bf16) or 1e-4 (f32) of max "
         "|plain|, for each of dq, dk, dv", **flash_bwd_row)
    done("flash_bwd")

    # ----------------------------------------------------------- 8. rollout
    fc = FIRMConfig()
    check(fc.batch_size == B and fc.n_objectives == N_OBJ,
          "FIRMConfig defaults changed")
    ref_params = transformer.init_params(cfg, generator=gen, device=dev)
    train, frozen = common.split_trainable(ref_params)
    # a policy one training step away from the reference: non-zero lora_B
    train = common.tree_map(
        lambda t: t + 1e-3 * torch.randn(t.shape, generator=gen, device=dev),
        train)
    policy = common.merge_trainable(train, frozen)
    ds = make_client_datasets(1, cfg.vocab, P, generator=gen, device=dev)[0]
    prompts = ds.next_batch(B)
    band_h, band_x = rewards.variant_bands(cfg.vocab)
    length_tol = max(4, MAX_NEW // 2)

    def rollout():
        return rollout_batch(cfg, policy, ref_params, prompts, band_h, band_x,
                             n_objectives=N_OBJ, max_new=MAX_NEW,
                             length_tol=length_tol, generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    batch, rollout_s = wall(rollout)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    per_forward = 2 * cfg.n_layers + 1
    rollout_launches = {"rmsnorm": per_forward * (1 + MAX_NEW + 1),
                        "flash_attention": 2 * cfg.n_layers}
    want_launches = dict(rollout_launches, rmsnorm_bwd=0,
                         flash_attention_bwd=0, gram=0)
    check(launches == want_launches,
          f"launch counts {launches}, expected {want_launches}")

    s_total = P + MAX_NEW
    tok, mask = batch.tokens, batch.response_mask
    check(tuple(tok.shape) == (B, s_total), f"tokens shape {tok.shape}")
    check(bool(((tok >= 0) & (tok < cfg.vocab)).all()), "token ids range")
    check(torch.equal(tok[:, :P], prompts), "prompt kept in the tokens")
    check(bool((mask[:, :P] == 0).all() and (mask[:, P:] == 1).all()),
          "response mask")
    for name in ("old_logprobs", "ref_logprobs"):
        lp = getattr(batch, name)
        check(tuple(lp.shape) == (B, s_total) and bool(lp.isfinite().all()),
              f"{name} finite of shape (B, S)")
        check(bool((lp <= 0).all()), f"{name} <= 0")
    check(bool((batch.old_logprobs[:, :P] == 0).all()), "prompt logprobs 0")
    r = batch.rewards
    check(tuple(r.shape) == (B, N_OBJ) and bool(r.isfinite().all()),
          "rewards shape")
    check(bool(((r >= 0) & (r <= 1)).all()), "rewards in [0, 1]")

    # teacher-forced: the same forward through the kernels and through the
    # plain versions, both in bf16, each against the plain forward in f32
    # (the same bf16 weights, upcast).  bf16 rounds at other places in the
    # kernels and the plain versions, so neither matches the other bit for
    # bit; the kernels' path must be as close to the f32 forward as the
    # plain path is: within 25% on the mean error and 50% on the largest.
    def logits_and_lp(p, **kw):
        logits = transformer.forward_seq(cfg, p, tok, **kw)["logits"]
        return logits.float(), ppo.token_logprobs(logits, tok)

    policy32 = common.tree_map(lambda t: t.float(), policy)
    logits_32, lp_32 = logits_and_lp(policy32, use_kernel=False)
    del policy32
    logits_k, lp_k = logits_and_lp(policy)
    logits_p, lp_p = logits_and_lp(policy, use_kernel=False)

    def err(a, b):
        d = (a - b).abs()
        return {"mean_abs": float(d.mean()), "max_abs": float(d.max())}

    tf = {"logits": {"kernels_vs_f32": err(logits_k, logits_32),
                     "plain_vs_f32": err(logits_p, logits_32),
                     "kernels_vs_plain": err(logits_k, logits_p),
                     "max_abs_value": float(logits_32.abs().max())},
          "logprobs": {"kernels_vs_f32": err(lp_k, lp_32),
                       "plain_vs_f32": err(lp_p, lp_32),
                       "kernels_vs_plain": err(lp_k, lp_p)}}
    # kernels against plain directly, at the CPU parity tests' bf16
    # tolerance (tests/test_torch_models.py): 2e-2 of the tensor's scale
    for what, got, want in (("logits", logits_k, logits_p),
                            ("logprobs", lp_k, lp_p)):
        limit = 2e-2 * max(1.0, float(want.abs().max()))
        tf[what]["kernels_vs_plain"]["limit"] = limit
        check(tf[what]["kernels_vs_plain"]["max_abs"] <= limit,
              f"teacher-forced {what}, kernels vs plain: {tf[what]}")
    del logits_32, logits_k, logits_p
    for what, e in tf.items():
        k, p = e["kernels_vs_f32"], e["plain_vs_f32"]
        check(k["mean_abs"] <= 1.25 * p["mean_abs"]
              and k["max_abs"] <= 1.5 * p["max_abs"],
              f"teacher-forced {what}: kernels further from f32 than the "
              f"plain path: {e}")

    # where the rollout's time goes (after the counted run)
    _, prefill_s = wall(lambda: transformer.prefill(
        cfg, policy, prompts, cache_len=s_total))
    (tokens2, _, mask2), generate_s = wall(lambda: generate(
        cfg, policy, prompts, max_new=MAX_NEW, generator=gen))
    _, rewards_s = wall(lambda: rewards.score_batch_banded(
        band_h, band_x, tokens2, mask2, N_OBJ, length_tol))
    _, ref_s = wall(lambda: ppo.token_logprobs(
        transformer.forward_seq(cfg, ref_params, tokens2)["logits"],
        tokens2))
    emit(phase="rollout", model=cfg.name, params=cfg.param_count(),
         batch=B, prompt_len=P, max_new=MAX_NEW, n_objectives=N_OBJ,
         seconds=rollout_s, generated_tokens_per_s=B * MAX_NEW / rollout_s,
         peak_memory_bytes=peak, launches=launches,
         teacher_forced=tf,
         tolerance="kernels vs plain bf16: max abs <= 2e-2 * max(1, max "
         "|plain|); kernels' error vs the f32 forward <= 1.25x (mean) and "
         "1.5x (max) the plain bf16 path's",
         reward_means=[float(x) for x in r.mean(0)],
         breakdown_s={"prefill": prefill_s,
                      "decode_128_steps": generate_s - prefill_s,
                      "generate": generate_s, "rewards": rewards_s,
                      "reference_logprobs": ref_s})

    # device busy share of decode: 8 steps under torch.profiler
    _, cache = transformer.prefill(cfg, policy, prompts,
                                   cache_len=P + MAX_NEW)
    step_tok = prompts[:, -1:]

    def decode_8():
        nonlocal cache
        for _ in range(8):
            _, cache = transformer.decode_step(cfg, policy, cache, step_tok)

    emit(phase="decode_profile", profile=device_profile(decode_8, 8))
    done("rollout")

    # -------------------------------------------------------- 9. local step
    # one client from the reference (lora_B = 0), K local steps, each a
    # rollout of B prompts and one firm_local_step, with FIRMConfig's
    # defaults (M = 2, B = 16, beta = 0.01, pgd with 100 iterations)
    k_steps = 2
    train0, frozen0 = common.split_trainable(ref_params)
    state0 = local.init_client_state(train0, fc.n_objectives, cfg.d_model,
                                     kl_coef=fc.kl_coef_init, device=dev)
    ds_local = make_client_datasets(1, cfg.vocab, P, generator=gen,
                                    device=dev)[0]
    torch.cuda.synchronize()
    zero_counts()
    (final, kept), local_s = wall(lambda: client_local_steps(
        cfg, fc, state0, frozen0, ref_params, band_h, band_x,
        k_steps=k_steps, max_new=MAX_NEW, length_tol=length_tol,
        dataset=ds_local, generator=gen))
    local_launches = read_counts()
    # per step: a rollout, then one forward and M backward pulls; layer 0's
    # ln1 reads the embedding, which needs no gradient, so a pull runs
    # 2 L norms backward (not 2 L + 1) and L attentions backward
    want_local = {
        "rmsnorm": k_steps * (rollout_launches["rmsnorm"] + per_forward),
        "flash_attention": k_steps * (rollout_launches["flash_attention"]
                                      + cfg.n_layers),
        "rmsnorm_bwd": k_steps * N_OBJ * 2 * cfg.n_layers,
        "flash_attention_bwd": k_steps * N_OBJ * cfg.n_layers,
        "gram": k_steps}
    check(local_launches == want_local,
          f"local-step launch counts {local_launches}, expected {want_local}")
    lam = kept["lam"]
    check(tuple(lam.shape) == (k_steps, N_OBJ) and bool((lam >= 0).all())
          and float((lam.sum(-1) - 1).abs().max()) < 1e-5,
          f"lambda on the simplex: {lam.tolist()}")
    check(bool(kept["kl"].isfinite().all() & kept["rewards"].isfinite().all()),
          "finite kl and rewards")
    check(int(final.step) == k_steps and int(final.opt.count) == k_steps,
          "step and Adam count advanced")
    moved = [bool((a != b).any()) for a, b in zip(
        common.tree_leaves(final.trainable), common.tree_leaves(train0))]
    check(all(moved), f"every adapter moved ({sum(moved)}/{len(moved)})")

    def attn_leaves(tree, name):
        """The ``name`` (lora_A or lora_B) leaves of wq, wk, wv, wo."""
        attn = tree["slots"]["0"]["attn"]
        return [attn[w][name] for w in sorted(attn)]

    # one firm_local_step on a fixed batch (the rollout phase's), uncounted:
    # at step 1 lora_B = 0, so every lora_A gradient is exactly 0
    grads0, _, _ = ppo.per_objective_grads(cfg, fc, train0, frozen0,
                                           state0.critic, batch,
                                           state0.kl_coef)
    for j, g_j in enumerate(grads0):
        check(all(bool((t == 0).all()) for t in attn_leaves(g_j, "lora_A")),
              f"objective {j}: a lora_A gradient is not 0 while lora_B = 0")
        check(all(bool((t != 0).any()) for t in attn_leaves(g_j, "lora_B")),
              f"objective {j}: a lora_B gradient is 0")
    del grads0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    (state1, metrics), update_s = wall(lambda: local.firm_local_step(
        cfg, fc, state0, frozen0, batch))
    update_peak = torch.cuda.max_memory_allocated()
    for key in ("losses", "grad_norm", "kl", "ratio_mean", "td_err"):
        check(bool(metrics[key].isfinite().all()), f"{key} finite")
    lam1 = metrics["lam"]
    check(bool((lam1 >= 0).all()) and abs(float(lam1.sum()) - 1) < 1e-5,
          f"lambda on the simplex: {lam1.tolist()}")
    check(int(state1.step) == 1 and int(state1.opt.count) == 1
          and float(state1.kl_coef) != float(state0.kl_coef),
          "step, Adam count and kl_coef advanced")
    check(all(bool((a != b).any()) for a, b in zip(
        attn_leaves(state1.trainable, "lora_B"),
        attn_leaves(train0, "lora_B"))), "lora_B moved")

    # the update's time by part, each ended by a synchronise
    with torch.enable_grad():
        tr = common.tree_map(lambda t: t.detach().requires_grad_(), train0)
        (losses, extras), fwd_s = wall(lambda: ppo.multi_objective_losses(
            cfg, fc, tr, frozen0, state0.critic, batch, state0.kl_coef))
        leaves = common.tree_leaves(tr)
        pulls, pulls_s = wall(lambda: [torch.autograd.grad(
            losses[j], leaves, retain_graph=j < N_OBJ - 1)
            for j in range(N_OBJ)])
    grads = []
    for flat in pulls:
        it = iter(flat)
        grads.append(common.tree_map(lambda _: next(it), tr))
    _, gram_s = wall(lambda: ops.gram_from_pytrees(grads))
    res, resolve_s = wall(lambda: firm.resolve(
        grads, fc, prev_lam=state0.lam,
        eta=firm.eta_schedule(state0.step + 1)))
    _, adam_s = wall(lambda: optim.adam_update(
        res.direction, state0.opt, state0.trainable, lr=fc.actor_lr,
        max_grad_norm=1.0))
    _, feats, r_tok, _, mask_ = extras
    _, critic_s = wall(lambda: critic.td_update(
        state0.critic, feats, r_tok, mask_, fc.gamma, fc.critic_lr,
        critic.r_w_bound(r_max=1.0)))
    check(grads[0]["slots"]["0"]["attn"]["wq"]["lora_B"].numel() > 0
          and sum(t.numel() for t in leaves) == d_lora,
          "the gradient row width is the gram phase's d")
    del tr, losses, extras, pulls, leaves, res
    update_profile = device_profile(lambda: local.firm_local_step(
        cfg, fc, state0, frozen0, batch), 1)

    # the M gradients on the fixed batch with non-zero lora_B (the rollout
    # phase's adapters), through the kernels, through the plain versions
    # and through an f32 copy of the model: the kernels' path must be as
    # close to f32 as the plain bf16 path is, within 25% on the relative L2
    # error and 60% on 1 - cosine (about 1.25 squared)
    def flat_grads(frz, **kw):
        g, _, _ = ppo.per_objective_grads(cfg, fc, train, frz, state0.critic,
                                          batch, state0.kl_coef, **kw)
        return [torch.cat([t.float().reshape(-1)
                           for t in common.tree_leaves(g_j)]) for g_j in g]

    g_kernel = flat_grads(frozen0)
    g_plain = flat_grads(frozen0, use_kernel=False)
    frozen32 = common.tree_map(lambda t: t.float(), frozen0)
    g_f32 = flat_grads(frozen32, use_kernel=False)
    del frozen32

    def compare(a, b):
        return {"rel_l2": float((a - b).norm() / b.norm()),
                "cosine": float(torch.dot(a, b) / (a.norm() * b.norm()))}

    grad_check = []
    for j in range(N_OBJ):
        e = {"kernels_vs_f32": compare(g_kernel[j], g_f32[j]),
             "plain_vs_f32": compare(g_plain[j], g_f32[j]),
             "kernels_vs_plain": compare(g_kernel[j], g_plain[j]),
             "norm_f32": float(g_f32[j].norm())}
        grad_check.append(e)
        k_, p_ = e["kernels_vs_f32"], e["plain_vs_f32"]
        check(k_["rel_l2"] <= 1.25 * p_["rel_l2"]
              and 1 - k_["cosine"] <= 1.6 * (1 - p_["cosine"]),
              f"objective {j}: kernels' gradient further from f32 than the "
              f"plain path's: {e}")
    g_stack = torch.stack(g_kernel)
    gram_path = {"rel_err_vs_plain": max_rel(gram_mod.gram(g_stack),
                                             ref.gram(g_stack))}
    check(gram_path["rel_err_vs_plain"] <= 1e-5,
          f"gram of the real gradients: {gram_path}")
    del g_kernel, g_plain, g_f32, g_stack
    # the same K steps again, uncounted, from the same start, with each
    # part of a step timed (the body of client_local_steps), then one
    # more rollout alone as a control for the host's speed at that time
    st, step_parts = state0, []
    for _ in range(k_steps):
        params = common.merge_trainable(st.trainable, frozen0)
        p_k, prompts_s = wall(lambda: ds_local.next_batch(B))
        b_k, roll_s = wall(lambda: rollout_batch(
            cfg, params, ref_params, p_k, band_h, band_x,
            n_objectives=N_OBJ, max_new=MAX_NEW, length_tol=length_tol,
            generator=gen))
        (st, _), upd_s = wall(lambda: local.firm_local_step(
            cfg, fc, st, frozen0, b_k))
        step_parts.append({"prompts": prompts_s, "rollout": roll_s,
                           "update": upd_s})
    del st, params, b_k
    _, control_rollout_s = wall(rollout)
    if update_profile is not None:
        # busy time over the update's wall time without the profiler, whose
        # own host cost stretches the traced window
        update_profile["device_busy_share_of_unprofiled_wall"] = (
            update_profile["device_busy_us_per_step"] / (update_s * 1e6))
    emit(phase="local_step", model=cfg.name, k_steps=k_steps,
         n_objectives=N_OBJ, batch=B, prompt_len=P, max_new=MAX_NEW,
         gradient_width=d_lora, seconds=local_s, launches=local_launches,
         warm_steps_s=step_parts, control_rollout_s=control_rollout_s,
         lam=lam.tolist(), kl=kept["kl"].tolist(),
         rewards=kept["rewards"].tolist(),
         update={"seconds": update_s,
                 "peak_memory_bytes": update_peak,
                 "memory_before_bytes": mem_before,
                 "losses": metrics["losses"].tolist(),
                 "grad_norm": float(metrics["grad_norm"]),
                 "lam_star": metrics["lam_star"].tolist(),
                 "gram": metrics["gram"].tolist(),
                 "breakdown_s": {"forward_and_losses": fwd_s,
                                 "backward_pulls": pulls_s,
                                 "gram": gram_s,
                                 "resolve_with_gram": resolve_s,
                                 "adam": adam_s, "critic_td": critic_s},
                 "profile": update_profile},
         rollout_seconds=rollout_s, gradient_check=grad_check,
         gram_of_real_gradients=gram_path,
         tolerance="kernels' gradient vs f32: rel L2 <= 1.25x and "
         "(1 - cosine) <= 1.6x the plain bf16 path's; gram 1e-5 of scale")
    done("local_step")

    # ------------------------------------------------------------ 10. serve
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        out, serve_s = wall(lambda: serve.main(
            ["--preset", "full", "--batch", "4", "--prompt-len", "32",
             "--max-new", "8", "--device", "cuda"]))
    check(tuple(out.shape) == (4, 8), f"serve output shape {out.shape}")
    emit(phase="serve", seconds=serve_s, report=report.getvalue())

    rows = (rms_row, rms_bwd_row, flash_row, flash_bwd_row, gram_row)
    for row in rows:
        row["launches"] = local_launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
