#!/usr/bin/env python3
"""Time the rmsnorm backward with dg against an earlier source, and the
current source at other row-group counts.

Run from the root of a checkout, on a machine with the card and ``nvcc``:

    git show <commit>:src/repro_torch/kernels/csrc/rmsnorm.cu \\
        > build/rmsnorm_old.cu
    python3 scripts/rmsnorm_dg_compare.py --old build/rmsnorm_old.cu \\
        --max-groups 256 512 2048

Builds each source alone with ``nvcc`` into ``build/rmsnorm_dg/``: the old
one, the current one, and the current one with ``kDgMaxGroups`` set to
each ``--max-groups`` value.  Every build's ``firm_rmsnorm_bwd`` gets one
scratch of rows x d floats, which holds any design's (the old one's rsqrt
a row, the current one's partials a row group).  Each build must give dx
the bits of its call without dg, dg the same bits twice, and dg within
1e-2 of the scale of the plain formula (``kernels.ref.rmsnorm_dg``; bf16)
or 1e-4 (f32).  Then times every build with dg at xlstm-125m's update
shape (4096, 768) and at (4096, 2048), bf16, in turns (each build, then
again in reverse order), the stream held by a sleep kernel while 100 calls
are queued.  Prints the card's name and power limit and one JSON line, and
exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((4096, 768), (4096, 2048))
CHECKS = (((4096, 768), "bf16"), ((4096, 768), "f32"), ((4096, 2048), "bf16"),
          ((3, 1001), "bf16"), ((16, 768), "bf16"))


def main() -> int:
    import torch

    from repro_torch.kernels import build, ref

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", metavar="PATH",
                    help="an earlier csrc/rmsnorm.cu")
    ap.add_argument("--max-groups", type=int, nargs="*", default=[],
                    help="kDgMaxGroups values to build the current source at")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_dg_compare: no CUDA device is available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)

    out = build.BUILD_DIR / "rmsnorm_dg"
    out.mkdir(parents=True, exist_ok=True)
    current = (build.CSRC / "rmsnorm.cu").read_text()
    sources = {"new": current}
    for n in opts.max_groups:
        src, hits = re.subn(r"kDgMaxGroups = \d+", f"kDgMaxGroups = {n}",
                            current)
        if hits != 1:
            raise SystemExit("kDgMaxGroups not found in rmsnorm.cu")
        sources[f"new_max_groups_{n}"] = src
    if opts.old:
        sources = {"old": Path(opts.old).read_text(), **sources}
    cmds, paths = [], {}
    for name, src in sources.items():
        (out / f"{name}.cu").write_text(src)
        paths[name] = out / f"lib{name}.so"
        cmds.append([build.tool(), *build.NVCC_FLAGS, "-shared", "-o",
                     str(paths[name]), str(out / f"{name}.cu")])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for cmd, proc in zip(cmds, procs):
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise SystemExit(f"build failed: {' '.join(cmd)}")
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.firm_rmsnorm_bwd.argtypes = build.SIGNATURES["firm_rmsnorm_bwd"]
        lib.firm_rmsnorm_bwd.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    dtypes = {"bf16": (torch.bfloat16, 1), "f32": (torch.float32, 0)}
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(rows, d, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for shape in ((rows, d), (d,), (rows, d))]

    def caller(lib, x, g, dy, code, want_dg):
        rows, d = x.shape
        dx = torch.empty_like(x)
        dg = torch.zeros_like(g)
        scratch = torch.empty(rows * d, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                dg.data_ptr() if want_dg else None,
                scratch.data_ptr() if want_dg else None, rows, d, 1e-5,
                code, stream)

        def call():
            err = lib.firm_rmsnorm_bwd(*args)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return dx, dg
        return call

    def bits(t):
        return t.contiguous().view(torch.uint8).clone()

    checks, ok = {}, True
    for (rows, d), dt in CHECKS:
        dtype, code = dtypes[dt]
        x, g, dy = inputs(rows, d, dtype)
        want = ref.rmsnorm_dg(x, g, dy).float()
        for name, lib in libs.items():
            dx0, _ = caller(lib, x, g, dy, code, False)()
            dx0 = bits(dx0)
            dx1, dg1 = (bits(t) for t in caller(lib, x, g, dy, code, True)())
            dx2, dg2 = caller(lib, x, g, dy, code, True)()
            torch.cuda.synchronize()
            err = float((dg2.float() - want).abs().max() / want.abs().max())
            tol = 1e-2 if dt == "bf16" else 1e-4
            row = {"dg_rel_err": err,
                   "dx_bits_without_dg": torch.equal(dx0, bits(dx2)),
                   "same_bits_twice": torch.equal(dx1, bits(dx2))
                   and torch.equal(dg1, bits(dg2))}
            checks[f"({rows}, {d}) {dt} {name}"] = row
            ok = ok and err <= tol and row["dx_bits_without_dg"] \
                and row["same_bits_twice"]

    # device clock cycles per ms of torch.cuda._sleep
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)

    def ms(fn, iters=100):
        for _ in range(10):
            fn()
        hold = 20.0
        while True:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            torch.cuda._sleep(int(hold * cycles_per_ms))
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            queued = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if queued < hold:
                return start.elapsed_time(end) / iters
            hold *= 4

    order = list(libs) + list(libs)[::-1]
    times = {}
    for rows, d in SHAPES:
        x, g, dy = inputs(rows, d, torch.bfloat16)
        key = f"({rows}, {d}) bf16"
        times[key] = {
            "with_dg_in_turns": [
                (name, ms(caller(libs[name], x, g, dy, 1, True)))
                for name in order],
            "without_dg_new": ms(caller(libs["new"], x, g, dy, 1, False))}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "ok": ok, "checks": checks,
                      "ms": times}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
