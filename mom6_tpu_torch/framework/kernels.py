"""Build and load the hand-written CUDA kernels of ``mom6_tpu_torch/csrc``.

The kernels are compiled at first use with nvcc, one compiler process
per source, all started together, and linked into one shared library
with a plain C interface that is loaded through ctypes (no PyTorch
headers, so a build takes seconds).  The library's file name carries a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  The build directory
``mom6_tpu_torch/_build`` is not tracked by git.

Every C entry point launches on the stream it is given, allocates
nothing, does not synchronise, and returns ``cudaGetLastError()``;
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

__all__ = ["build", "library", "entry", "check", "stream_of", "BUILD_DIR",
           "SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = sorted(glob.glob(os.path.join(CSRC, "*.cu")))

# --fmad=false: no multiply-add contraction, so each kernel performs the
# same roundings as its plain PyTorch version (one op per rounding)
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "--fmad=false", "-Xptxas", "-v"]
LINK_FLAGS = _ARCH + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argtypes (the stream is the last argument of each)
_SIGNATURES = {
    # a, b, c, d, x, nz, m, nb, d_sk, d_sb, x_sk, x_sb, stream
    "mom6_tridiag": [_P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _L, _L, _P],
    # h, mask, h_L, h_R, nz, ny, nx, dir, fold, limiter, h_min, stream
    "mom6_ppm_edges": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_double, _P],
    # h, mask, h_L, h_R, nz, ny, nx, fold, limiter, h_min, stream (the y
    # pass over a mesh tile with its halo rows)
    "mom6_ppm_edges_halo": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                            ctypes.c_double, _P],
    # h, h_L, h_R, face, d_p, d_m, u, dw, rem, uh, duhdu, nz, ny, nx, dir,
    # fold, face3d, stream
    "mom6_ppm_flux": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P],
    # coef, h0, h1, lo, hi, out, nf, npoly, nz0, nz1, columns, stream
    "mom6_remap": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
}

_LIB = None
BUILD_SECONDS = None      # wall time of the build in this process, if any


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "mom6_tpu_torch are built with the CUDA toolkit")
    return path


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library if it is not built yet; return its path.  The
    compilers' output (ptxas register and spill counts) is kept in
    ``<lib>.log``."""
    global BUILD_SECONDS
    so = os.path.join(BUILD_DIR, f"libmom6_kernels_{_key()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:                 # a no-op once a process ended
                p.kill()
                p.wait()
        cmds = [(os.path.basename(s), p.returncode, out)
                for s, p, out in zip(SOURCES, procs, outs)]
        if all(rc == 0 for _, rc, _ in cmds):
            r = subprocess.run([nvcc] + LINK_FLAGS + ["-o", tmp + "/lib.so"]
                               + objs, capture_output=True, text=True,
                               timeout=600)
            cmds.append(("link", r.returncode, r.stdout + r.stderr))
        with open(so + ".log", "w") as f:
            f.write("\n".join(f"== {n}\n{out}" for n, _, out in cmds))
        failed = [f"{n} ({rc}):\n{out[-4000:]}" for n, rc, out in cmds if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp + "/lib.so", so)
    BUILD_SECONDS = time.time() - t0
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for dt in ("f32", "f64"):
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, f"{name}_{dt}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def entry(name: str, dtype):
    """The C entry point ``name`` for a float32 or float64 tensor."""
    if dtype == torch.float32:
        return getattr(library(), f"{name}_f32")
    if dtype == torch.float64:
        return getattr(library(), f"{name}_f64")
    raise TypeError(f"{name}: no kernel for dtype {dtype}")


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device, which
    must be the current CUDA device: the kernels launch there."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream
