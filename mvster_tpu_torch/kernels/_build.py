"""Build and load the port's CUDA kernels (mvster_tpu_torch/csrc/*.cu).

At first use, nvcc compiles every source under csrc/ into one shared
library with a plain C interface, which is then loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib.so csrc/*.cu

The library lands in build/mvster_tpu_torch/<hash>/ at the repository
root, keyed by a hash of the sources, so an edited source is rebuilt and an
unchanged one is loaded as it is.  ptxas's register and spill report is
kept beside it as nvcc.log.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "mvster_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process ran


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libmvster_tpu_torch.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    global build_seconds
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    # build into a temporary name and rename, so concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
        capture_output=True, text=True,
    )
    (lib_path.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C functions' signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mvster_warp_correlate.argtypes = [
            p, p, p, p, p, p,           # ref, src, hypo, rot, trans, out
            i, i, i, i, i, i, i,        # B, V, D, H, W, C, G
            i, f, f,                    # attn_fuse_d, attn_temp, sqrt_c
            p,                          # cudaStream_t
        ]
        lib.mvster_warp_correlate.restype = i
        lib.mvster_cuda_error_string.argtypes = [i]
        lib.mvster_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
