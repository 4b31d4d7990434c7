#!/usr/bin/env python3
"""Where the SSD kernels' time goes: a kernel timed with one step of it
removed at a time, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and ``nvcc``:

    python3 scripts/ssd_phase_times.py

Each variant is ``src/repro_torch/kernels/csrc/ssd.cu`` (the forward) or
``ssd_bwd.cu`` (the backward) with one step's work cut out by a text
substitution (its output is wrong by construction; nothing checks it),
built with ``nvcc`` into ``build/ssd_phases/`` and timed at the training
shape (B = 16, S = 256, nh = 64, hd = ds = 64; the forward with the final
state, the backward without a d(final state)) with CUDA events over 50
calls, in two rounds.  Forward: ``copies_only`` keeps the copies, waits,
scans and stores and cuts every product.  Backward: the states kernel,
C B^T, the row and column passes' pair loops, dy^T h0, x^T dh, dh B_j,
the new dh and the serial d(da) sum, one at a time.  Prints the card's
name and power limit, then one line per variant of each kernel.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

P2 = ("    if (!first) {\n      for (int h = h0; h < h1; ++h) {",
      "    if (false) {\n      for (int h = h0; h < h1; ++h) {")
INTRA = ("for (int jt = 0; jt <= lim[p]; ++jt) {",
         "for (int jt = 0; jt < 0; ++jt) {")
STATE = ("      if (update) {", "      if (false) {")
CB = ("          mma3(cbacc[k], th, tl, bh, bl);", "")
SCAN = ("if (tid == 0) scan_L(sm.L);", "")
VARIANTS = {"base": [], "no_inter": [P2], "no_intra": [INTRA],
            "no_state": [STATE], "no_cb": [CB], "no_scan": [SCAN],
            "copies_only": [P2, INTRA, STATE, CB]}
BWD_VARIANTS = {
    "base": [],
    "no_states": [("  for (int c = 0; c + 1 < nchunks; ++c) {",
                   "  for (int c = 0; c + 1 < 0; ++c) {")],
    "no_cb": [("      if (j <= i) {\n        float s0",
               "      if (false) {\n        float s0")],
    "no_row_pairs": [("const int jmax = min(16 * warp + 15, n - 1);",
                      "const int jmax = -1;")],
    "no_col_pairs": [("for (int i = 16 * warp; i < n; ++i) {",
                      "for (int i = 16 * warp; i < 0; ++i) {")],
    "no_dyT_h0": [("        if (h0h) {\n          float4 u[kVS];",
                   "        if (false) {\n          float4 u[kVS];")],
    "no_xT_dh": [("row_times_state<DS, HS::kRow, HS::kOff>(v, sm.x + j * "
                  "HD::kRow,\n                                                "
                  "sm.state, p);", "for (int k = 0; k < kVS; ++k) v[k] = "
                  "make_float4(0.f, 0.f, 0.f, 0.f);")],
    "no_dh_B": [("for (int s = 0; s < DS; s += 4) {\n            const "
                 "float4 b4", "for (int s = 0; s < 0; s += 4) {\n         "
                 "   const float4 b4")],
    "no_new_dh": [("      for (int i = 0; i < n; ++i) {\n        const float "
                   "eli", "      for (int i = 0; i < 0; ++i) {\n        "
                   "const float eli")],
    "no_dda_sum": [("        if (tid == 0) {\n          // d(da)_k",
                    "        if (false) {\n          // d(da)_k")]}


def build_variants(out: Path, source: str, variants: dict) -> None:
    src = (build.CSRC / source).read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {source} no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.tool(), *build.NVCC_FLAGS[:-2], "-shared", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")


def time_variants(out: Path, entry: str, args: list, variants) -> dict:
    """Mean ms of each variant's ``entry`` over 50 calls, in two rounds."""
    times = {name: [] for name in variants}
    for _ in range(2):
        for name in variants:
            fn = getattr(ctypes.CDLL(str(out / f"{name}.so")), entry)
            fn.argtypes = build.SIGNATURES[entry]

            def call():
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            for _ in range(5):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(50):
                call()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / 50)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_phase_times: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out = build.BUILD_DIR / "ssd_phases"
    build_variants(out / "fwd", "ssd.cu", VARIANTS)
    build_variants(out / "bwd", "ssd_bwd.cu", BWD_VARIANTS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, nh, hd, ds = 16, 256, 64, 64, 64
    F = torch.nn.functional
    xbc = F.silu(torch.randn((b, s, nh * hd + 2 * ds), generator=gen,
                             device=dev))
    x = xbc[..., :nh * hd].view(b, s, nh, hd)
    bm, cm = xbc[..., nh * hd:nh * hd + ds], xbc[..., nh * hd + ds:]
    dt = F.softplus(torch.randn((b, s, nh), generator=gen, device=dev))
    da = dt * -torch.linspace(1.0, 16.0, nh, device=dev)
    dy = torch.randn((b, s, nh, hd), generator=gen, device=dev)
    strides = [*x.stride()[:3], *bm.stride()[:2], *cm.stride()[:2],
               *dt.stride()[:2], *da.stride()[:2]]
    groups = ctypes.c_int(0)
    build.load().firm_ssd_bwd_groups(nh, ctypes.byref(groups))
    fwd_out = [torch.empty(shape, device=dev) for shape in (
        (b, s, nh, hd), (b, nh, hd, ds))]
    bwd_out = [torch.empty(shape, device=dev) for shape in (
        (b, s, nh, hd), (b, s, ds), (b, s, ds), (b, s, nh), (b, s, nh),
        (b, -(-s // 128) - 1, nh, hd, ds), (b, nh, hd, ds),
        (b, groups.value, s, ds), (b, groups.value, s, ds))]
    ins = [t.data_ptr() for t in (x, bm, cm, dt, da)]
    for label, times in (
            ("forward", time_variants(
                out / "fwd", "firm_ssd_scan",
                ins + [t.data_ptr() for t in fwd_out] + [1, b, s, nh, ds,
                                                         *strides],
                VARIANTS)),
            ("backward", time_variants(
                out / "bwd", "firm_ssd_scan_bwd",
                ins + [dy.data_ptr(), None]
                + [t.data_ptr() for t in bwd_out] + [b, s, nh, ds,
                                                     *strides],
                BWD_VARIANTS))):
        print(label)
        for name, ms in times.items():
            print(f"  {name:12s} " + " ".join(f"{t:.4f} ms" for t in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
