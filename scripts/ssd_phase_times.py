#!/usr/bin/env python3
"""Where the SSD kernels' time goes: a kernel timed with one step of it
removed at a time, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and ``nvcc``:

    python3 scripts/ssd_phase_times.py [--old-bwd PATH]

Each variant is ``src/repro_torch/kernels/csrc/ssd.cu`` (the forward) or
``ssd_bwd.cu`` (the backward) with one step's work cut out by a text
substitution (its output is wrong by construction; nothing checks it),
built with ``nvcc`` into ``build/ssd_phases/`` and timed at the training
shape (B = 16, S = 256, nh = 64, hd = ds = 64; the forward with the final
state, the backward without a d(final state)) with CUDA events over 50
calls, in two rounds.  Forward: ``copies_only`` keeps the copies, waits,
scans and stores and cuts every product.  Backward: the boundary-state
launch, C B^T, dS^T, u and v, dx, G B and G^T C, and the scans (L and
d(da)), one at a time.  ``--old-bwd`` adds a variant built unchanged from
another backward source with the same C entry (an earlier design, e.g.
``git show <commit>:src/repro_torch/kernels/csrc/ssd_bwd.cu >
build/ssd_bwd_old.cu``), timed in the same rounds.  Prints the card's name
and power limit, then one line per variant of each kernel.
"""
from __future__ import annotations

import argparse
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
    "no_states": [("  for (int step = 0; step + 1 < nc; ++step) {",
                   "  for (int step = 0; step + 1 < 0; ++step) {")],
    "no_cb": [("      mma3(cbf[kk], th, tl, bh, bl);", "")],
    "no_ds": [("          mma3(acc[kk], th, tl, bh, bl);", "")],
    "no_u_v": [("    if (has_h0) {\n      float ua", "    if (false) {\n"
                "      float ua"),
               ("    if (has_dh) {\n      float va", "    if (false) {\n"
                "      float va")],
    "no_dx": [("      for (int qi = 2 * q; qi < 16; ++qi) {\n        uint32_t",
               "      for (int qi = 2 * q; qi < 0; ++qi) {\n        uint32_t"),
              ("      if (has_dh) {\n#pragma unroll 2\n        for (int ks",
               "      if (false) {\n#pragma unroll 2\n        for (int ks")],
    "no_gb_gtc": [("for (int qi = 2 * r; qi < 16; ++qi) {     // dB_j",
                   "for (int qi = 2 * r; qi < 0; ++qi) {     // dB_j"),
                  ("for (int qj = 0; qj <= 2 * r + 1; ++qj) {",
                   "for (int qj = 0; qj < 0; ++qj) {")],
    "no_scans": [("one thread a head\n  if (tid < nhg) scan_L(sm.L + tid "
                  "* kChunk);", "one thread a head\n"),
                 ("  if (lane == 0 && warp < nhg) {", "  if (false) {")]}


def build_variants(out: Path, source: str, variants: dict,
                   extra: dict | None = None) -> None:
    """Build each variant of csrc/``source``, and each source of ``extra``
    (name -> path) as it is."""
    src = (build.CSRC / source).read_text()
    out.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {source} no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        texts[name] = text
    for name, path in (extra or {}).items():
        texts[name] = Path(path).read_text()
    procs = {}
    for name, text in texts.items():
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
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--old-bwd", metavar="PATH", default=None,
                      help="another ssd_bwd.cu to time beside the variants")
    opts = args.parse_args()
    if not torch.cuda.is_available():
        print("ssd_phase_times: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out = build.BUILD_DIR / "ssd_phases"
    build_variants(out / "fwd", "ssd.cu", VARIANTS)
    bwd_variants = dict(BWD_VARIANTS)
    extra = {}
    if opts.old_bwd:
        extra["old_design"] = opts.old_bwd
        bwd_variants["old_design"] = []
    build_variants(out / "bwd", "ssd_bwd.cu", BWD_VARIANTS, extra)
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
    # scratch as the wrapper sizes it, large enough for the first design
    # too (its dh is (b, nh, hd, ds); its groups are as many)
    nc = -(-s // 128)
    bwd_out = [torch.empty(shape, device=dev) for shape in (
        (b, s, nh, hd), (b, s, ds), (b, s, ds), (b, s, nh), (b, s, nh),
        (b, nc - 1, nh, ds, hd), (b, max(nc - 1, 1), nh, hd, ds),
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
                bwd_variants))):
        print(label)
        for name, ms in times.items():
            print(f"  {name:12s} " + " ".join(f"{t:.4f} ms" for t in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
