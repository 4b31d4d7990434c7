#!/usr/bin/env python3
"""Where the SSD kernel's time goes: the kernel timed with one step of it
removed at a time, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and ``nvcc``:

    python3 scripts/ssd_phase_times.py

Each variant is ``src/repro_torch/kernels/csrc/ssd.cu`` with one step's
work cut out by a text substitution (its output is wrong by construction;
nothing checks it), built with ``nvcc`` into ``build/ssd_phases/`` and
timed at the reference forward's shape (B = 16, S = 256, nh = 64,
hd = ds = 64, with the final state) with CUDA events over 50 calls, in
two rounds.  ``copies_only`` keeps the copies, waits, scans and stores
and cuts every product.  Prints the card's name and power limit, then one
line per variant.
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


def build_variants(out: Path) -> None:
    src = (build.CSRC / "ssd.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: ssd.cu no longer holds {old!r}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_phase_times: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out = build.BUILD_DIR / "ssd_phases"
    build_variants(out)
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
    y = torch.empty((b, s, nh, hd), device=dev)
    state = torch.empty((b, nh, hd, ds), device=dev)
    strides = [*x.stride()[:3], *bm.stride()[:2], *cm.stride()[:2],
               *dt.stride()[:2], *da.stride()[:2]]
    times = {name: [] for name in VARIANTS}
    for _ in range(2):
        for name in VARIANTS:
            fn = ctypes.CDLL(str(out / f"{name}.so")).firm_ssd_scan
            fn.argtypes = build.SIGNATURES["firm_ssd_scan"]

            def call():
                err = fn(x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                         dt.data_ptr(), da.data_ptr(), y.data_ptr(),
                         state.data_ptr(), 1, b, s, nh, ds, *strides,
                         torch.cuda.current_stream().cuda_stream)
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
    for name, ms in times.items():
        print(f"{name:12s} " + " ".join(f"{t:.4f} ms" for t in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
