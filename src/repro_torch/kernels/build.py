"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` is compiled to an object by its own ``nvcc``, all of
them started together, and one more ``nvcc`` links the objects into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds).  The library is placed under ``build/`` at the repository
root and named by a hash of the sources and flags: an edited source builds
a new library.  The build happens at first use, never at import.  A failed
build raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; each returns cudaGetLastError() as int
SIGNATURES = {
    # x, g, y, rows, d, eps, dtype, stream
    "firm_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _P),
    # x, g, dy, dx, rows, d, eps, dtype, stream
    "firm_rmsnorm_bwd": (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    # q, k, v, o, lse, b, sq, skv, hq, hkv, dh, causal, window, dtype, stream
    "firm_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P),
    # q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, skv, hq, hkv, dh,
    # causal, window, dtype, stream
    "firm_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, partials, g, m, d, n_blocks, dtype, stream
    "firm_gram": (_P, _P, _P, _I, _I, _I, _I, _P),
}


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"firm_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run_all(cmds) -> tuple[str, bool]:
    """Run the commands at once; their transcript and whether all passed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log, ok = "", True
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log += (f"$ {' '.join(cmd)}\n{out}"
                f"[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
        ok = ok and proc.returncode == 0
    return log, ok


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.

    Returns the library's path.  The compilers' output (ptxas register and
    shared-memory counts included) is kept beside it as ``.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log, ok = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources(), objs)])
    if ok:
        link_log, ok = _run_all([[_nvcc(), "-shared", "-o", str(tmp),
                                  *map(str, objs)]])
        log += link_log
    lib.with_suffix(".log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if not ok:
        raise RuntimeError(f"nvcc failed building the kernels:\n{log}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library with its signatures set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
