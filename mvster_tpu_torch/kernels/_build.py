"""Build and load the port's CUDA kernels (mvster_tpu_torch/csrc/*.cu).

At first use, nvcc compiles every source under csrc/ (one nvcc process per
source, all started together) and links them into one shared library with
a plain C interface, which is then loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o x.o csrc/x.cu      # each source
    nvcc ... -shared -o lib.so *.o

The library lands in build/mvster_tpu_torch/<hash>/ at the repository
root, keyed by a hash of the sources, so an edited source is rebuilt and an
unchanged one is loaded as it is.  ptxas's register and spill report is
kept beside it as nvcc.log.  Nothing here runs at import time.

`hashed_path` and `publish` (the hash-keyed directory and the build into a
temporary file renamed into place) serve eval/dtu_metric.py's host C++
library too.
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


def hashed_path(root: Path, sources: list[Path], flags: list[str], name: str,
                salt: str = "") -> Path:
    """root/<hash>/name, the hash taken over the sources' names and bytes,
    the compiler flags and `salt`: edited sources or flags build anew."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(flags).encode())
    digest.update(salt.encode())
    return root / digest.hexdigest()[:16] / name


def publish(lib_path: Path, make) -> None:
    """Run make(tmp) to write a library into a temporary file beside
    lib_path, then rename it into place: concurrent builds never load a
    half-written library.  The temporary file is removed if make raises."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
    os.close(fd)
    try:
        make(tmp)
    except BaseException:
        os.unlink(tmp)
        raise
    os.replace(tmp, lib_path)


def library_path() -> Path:
    return hashed_path(BUILD_ROOT, _sources(), NVCC_FLAGS, "libmvster_tpu_torch.so")


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    global build_seconds
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    cu = [s for s in _sources() if s.suffix == ".cu"]

    def make(tmp):
        # one nvcc per source, all started together, then one link
        objs = [f"{tmp}.{src.stem}.o" for src in cu]
        nvcc = _nvcc()
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        procs = [
            subprocess.Popen([nvcc, *compile_flags, "-c", "-o", obj, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(cu, objs)
        ]
        logs, failed = [], []
        for src, proc in zip(cu, procs):
            out, err = proc.communicate()
            logs.append(f"== {src.name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{err}")
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *objs],
                                  capture_output=True, text=True)
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link (exit {link.returncode}):\n{link.stderr}")
        (lib_path.parent / "nvcc.log").write_text("\n".join(logs))
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))

    t0 = time.perf_counter()
    publish(lib_path, make)
    build_seconds = time.perf_counter() - t0
    return lib_path


def check_tensor(name, t, device, dtype, shape=None) -> None:
    """Raise ValueError unless t lies on `device` as a contiguous `dtype`
    tensor (of `shape`, where given), as a kernel's raw pointer needs it."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def raise_on_error(lib: ctypes.CDLL, rc: int, fn_name: str) -> None:
    """Raise RuntimeError for the nonzero cudaGetLastError() code that a C
    function of the library returned."""
    if rc != 0:
        msg = lib.mvster_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} kernel launch failed: {msg} ({rc})")


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C functions' signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mvster_warp_correlate.argtypes = [
            p, p, p, p, p, p,           # ref, src, hypo, rot, trans, out
            i, i, i, i, i,              # B, V, D, H, W
            i, i, i,                    # Hs, Ws, row0
            i, i,                       # C, G
            i, f, f,                    # attn_fuse_d, attn_temp, sqrt_c
            i, i, i, i, i,              # maxg, split, pixels, threads, smem bytes
            p,                          # cudaStream_t
        ]
        lib.mvster_warp_correlate.restype = i
        for name in ("mvster_warp_gather", "mvster_warp_scatter"):
            fn = getattr(lib, name)
            fn.argtypes = [
                p, p, p, p,             # src|cot, x, y, out|dsrc
                i, i, i, i, i,          # B, N, Hs, Ws, C
                i, i, i,                # vec4, lanes_log2, spl
                p,                      # cudaStream_t
            ]
            fn.restype = i
        lib.mvster_sinkhorn_fwd.argtypes = [
            p, p, p,                    # pred, gt_idx, loss
            i, i, i, i, f,              # B, N, D, iters, eps
            i, i, i,                    # design (0 lanes, 1 thread), capacity, threads
            p,                          # cudaStream_t
        ]
        lib.mvster_sinkhorn_fwd.restype = i
        lib.mvster_sinkhorn_bwd.argtypes = [
            p, p, p, p,                 # pred, gt_idx, g, dpred
            i, i, i, i, f,              # B, N, D, iters, eps
            i, i,                       # design, capacity
            i, i,                       # threads per block, shared-memory bytes
            p,                          # cudaStream_t
        ]
        lib.mvster_sinkhorn_bwd.restype = i
        ll = ctypes.c_longlong
        lib.mvster_conv_wgrad.argtypes = [
            p, p, p, p,                 # g, x, part, dw
            i, i, i, i, i,              # B, D, M, C, stride
            i, i, i, i, i, i,           # Ho, Wo, Hi, Wi, ph, pw
            ll, ll, ll, ll, ll,         # g's strides
            ll, ll, ll, ll, ll,         # x's strides
            i, i, i,                    # tile rows, tile columns, blocks
            p,                          # cudaStream_t
        ]
        lib.mvster_conv_wgrad.restype = i
        lib.mvster_deform_conv.argtypes = [
            p, p, p, p, p,              # x (channels last), offsets, mask, weight, out
            i, i, i, i, i, i,           # B, C, h, W, Hw, row0
            p,                          # cudaStream_t
        ]
        lib.mvster_deform_conv.restype = i
        lib.mvster_deform_conv_prepare.argtypes = []
        lib.mvster_deform_conv_prepare.restype = i
        lib.mvster_cuda_error_string.argtypes = [i]
        lib.mvster_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
