#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device:  the card's name and power limit; TF32 off for matmuls and cuDNN.
2. build:   ``nvcc`` compiles every kernel of ``src/repro_torch/kernels/csrc``.
3. rmsnorm: the CUDA kernel against its plain PyTorch version at the
            rollout's shapes, then timed beside ``F.rms_norm``.
4. flash:   the CUDA flash-attention kernel against its plain version
            (causal, ragged, non-causal, sliding window, f32), then timed
            beside ``F.scaled_dot_product_attention``.
5. rollout: ``fed.engine.rollout_batch`` on llama-3.2-1b at full width
            (random weights from a seeded generator): 16 prompts of 128
            tokens, 128 new tokens, 2 objectives.  The kernels' launch counts
            are zeroed just before it and must be exactly 4290 (rmsnorm)
            and 32 (flash attention) just after.  The outputs are checked,
            and a teacher-forced bf16 forward through the kernels must
            agree with the plain bf16 forward within 2e-2 of the logits'
            scale and be as close to the f32 forward as the plain one is.
            Then, uncounted: the rollout's steps timed one by one, and 8
            decode steps under ``torch.profiler`` for the device's idle
            share.
6. serve:   the ``launch.serve`` CLI at full width, a few tokens.

Every number is printed as JSON on a line of its own; the second-to-last
line holds the per-kernel table and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from repro_torch.configs import FIRMConfig, get_config
    from repro_torch.data.partition import make_client_datasets
    from repro_torch.fed.engine import rollout_batch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import rmsnorm as rn_mod
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.rlhf import ppo, rewards
    from repro_torch.rlhf.sampling import generate

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

    # ----------------------------------------------------------- 5. rollout
    cfg = get_config("llama-3.2-1b")
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
    rn_mod.launches = 0
    fa_mod.launches = 0
    batch, rollout_s = wall(rollout)
    launches = {"rmsnorm": rn_mod.launches,
                "flash_attention": fa_mod.launches}
    peak = torch.cuda.max_memory_allocated()
    per_forward = 2 * cfg.n_layers + 1
    want_launches = {"rmsnorm": per_forward * (1 + MAX_NEW + 1),
                     "flash_attention": 2 * cfg.n_layers}
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

    # device busy share of decode: 8 steps under torch.profiler; the window
    # runs from the first kernel's start to the last one's end
    _, cache = transformer.prefill(cfg, policy, prompts,
                                   cache_len=P + MAX_NEW)
    step_tok = prompts[:, -1:]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            _, cache = transformer.decode_step(cfg, policy, cache, step_tok)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    decode_profile = None                      # "not measured"
    if kernels:
        busy = sum(e.time_range.elapsed_us() for e in kernels)
        window = (max(e.time_range.end for e in kernels)
                  - min(e.time_range.start for e in kernels))
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        decode_profile = {
            "steps": 8, "kernels_per_step": len(kernels) / 8,
            "device_busy_us_per_step": busy / 8,
            "window_us_per_step": window / 8,
            "device_idle_share": 1 - busy / window,
            "top_kernels_us_per_step": {n: t / 8 for n, t in top}}
    emit(phase="decode_profile", profile=decode_profile)

    # ------------------------------------------------------------- 6. serve
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        out, serve_s = wall(lambda: serve.main(
            ["--preset", "full", "--batch", "4", "--prompt-len", "32",
             "--max-new", "8", "--device", "cuda"]))
    check(tuple(out.shape) == (4, 8), f"serve output shape {out.shape}")
    emit(phase="serve", seconds=serve_s, report=report.getvalue())

    rms_row["launches"] = launches["rmsnorm"]
    flash_row["launches"] = launches["flash_attention"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in (rms_row, flash_row)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
