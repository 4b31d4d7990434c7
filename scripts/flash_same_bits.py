#!/usr/bin/env python3
"""Hold the flash-attention kernels below head_dim 128 to an earlier source.

Run from the root of a checkout, on a machine with the card and ``nvcc``:

    git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/flash_attention_old.cu
    python3 scripts/flash_same_bits.py --old build/flash_attention_old.cu

Builds the old source alone with ``nvcc`` into ``build/flash_old/`` and the
current kernels through ``kernels.build``, then calls both libraries' C
entries (``firm_flash_attention`` and ``firm_flash_attention_bwd``) on the
same inputs at the head dims both take (16, 32 and 64): the forward's o
and lse and the backward's dq, dk and dv must be the same bits, bf16 and
f32, at the shapes of ``chip_smoke.py``'s flash cases below head_dim 128
(its ``FLASH_CASES``, ``FLASH_EDGE_CASES`` and ``FLASH_BWD_CASES``).
Then times both forwards and both backwards at the rollout's shape (B=16,
S=256, 32 query and 8 KV heads, Dh=64, causal, bf16) in turns (old, new,
new, old), CUDA events around 100 back-to-back calls.  Prints the card's
name and power limit, one JSON line of results (with each build's
registers and spills of every flash kernel below head_dim 128, from its
``-Xptxas -v`` log), and exits non-zero if any bits differ.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the flash cases and the ptxas log parser)

# (b, sq, skv, hq, hkv, dh, dtype, causal, window), each shape once
CASES = list(dict.fromkeys(
    (*shape, dt, int(causal), window)
    for _, shape, dt, causal, window in (
        chip_smoke.FLASH_CASES + chip_smoke.FLASH_EDGE_CASES
        + chip_smoke.FLASH_BWD_CASES)
    if shape[-1] < 128))
KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_fma_kernel",
           "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel",
           "flash_bwd_dq_fma_kernel", "flash_bwd_dkv_fma_kernel")


def registers(log: str) -> dict:
    """Registers and spills of each flash kernel below head_dim 128."""
    out = {}
    for name in KERNELS:
        out.update({k: v for k, v in chip_smoke.parse_ptxas(log, name).items()
                    if not k.endswith("<128>")})
    return out


def main() -> int:
    import torch

    from repro_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, metavar="PATH",
                    help="an earlier csrc/flash_attention.cu")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_same_bits: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)

    out = build.BUILD_DIR / "flash_old"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libflash_old.so"
    old_log = subprocess.run([build.tool(), *build.NVCC_FLAGS, "-shared",
                              "-o", str(lib_path), opts.old], check=True,
                             capture_output=True, text=True)
    old_log = old_log.stdout + old_log.stderr
    libs = {"old": ctypes.CDLL(str(lib_path)), "new": build.load()}
    for lib in libs.values():
        for name in ("firm_flash_attention", "firm_flash_attention_bwd"):
            getattr(lib, name).argtypes = build.SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int

    dev = torch.device("cuda")
    dtypes = {"bf16": (torch.bfloat16, 1), "f32": (torch.float32, 0)}
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, sq, skv, hq, hkv, dh, dt):
        return [torch.randn(shape, generator=gen, device=dev).to(dt)
                for shape in ((b, sq, hq, dh), (b, skv, hkv, dh),
                              (b, skv, hkv, dh), (b, sq, hq, dh))]

    def run(lib, q, k, v, do, causal, window, code):
        b, sq, hq, dh = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        stream = torch.cuda.current_stream().cuda_stream
        o = torch.empty_like(q)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        dsum = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        err = lib.firm_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, skv, hq, hkv, dh, causal, window, code,
            stream)
        err = err or lib.firm_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq, hkv, dh, causal,
            window, code, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return o, lse, dq, dk, dv

    def same(a, b) -> bool:
        return torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))

    results, all_same = {}, True
    for b, sq, skv, hq, hkv, dh, dt, causal, window in CASES:
        dtype, code = dtypes[dt]
        q, k, v, do = inputs(b, sq, skv, hq, hkv, dh, dtype)
        got = {name: run(lib, q, k, v, do, causal, window, code)
               for name, lib in libs.items()}
        torch.cuda.synchronize()
        flags = {name: same(a, b_) for name, a, b_ in zip(
            ("o", "lse", "dq", "dk", "dv"), got["old"], got["new"])}
        label = (f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} Dh={dh} {dt} "
                 f"causal={causal} window={window}")
        results[label] = flags
        all_same = all_same and all(flags.values())

    q, k, v, do = inputs(16, 256, 256, 32, 8, 64, torch.bfloat16)
    o, lse, *_ = run(libs["new"], q, k, v, do, 1, 0, 1)
    stream = torch.cuda.current_stream().cuda_stream
    dsum = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

    def fwd(lib):
        return lambda: lib.firm_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
            16, 256, 256, 32, 8, 64, 1, 0, 1, stream)

    def bwd(lib):
        return lambda: lib.firm_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), 16, 256, 256, 32, 8, 64, 1, 0, 1,
            stream)

    def ms(fn, iters=100):
        for _ in range(10):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    times = {}
    for part, make in (("fwd", fwd), ("bwd", bwd)):
        times[part] = [(name, ms(make(libs[name])))
                       for name in ("old", "new", "new", "old")]
    new_log = build.library_path().with_suffix(".log").read_text()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "same_bits": all_same,
                      "cases": results,
                      "ms_rollout_shape_in_turns": times,
                      "registers": {"old": registers(old_log),
                                    "new": registers(new_log)}}),
          flush=True)
    return 0 if all_same else 1


if __name__ == "__main__":
    sys.exit(main())
