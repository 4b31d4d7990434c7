"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ONE ``nvcc`` call into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), placed under ``build/`` at the repository root and named by a
hash of the sources and flags: an edited source builds a new library.
The build happens at first use, never at import.  A failed build raises;
nothing falls back to another implementation.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; each returns cudaGetLastError() as int
SIGNATURES = {
    # x, g, y, rows, d, eps, dtype, stream
    "firm_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _P),
    # q, k, v, o, b, sq, skv, hq, hkv, dh, causal, window, dtype, stream
    "firm_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P),
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


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.

    Returns the library's path.  The compiler's output (ptxas register and
    shared-memory counts included) is kept beside it as ``.log``.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
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
