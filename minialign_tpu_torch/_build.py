"""Build and load the port's CUDA kernels.

The sources in csrc/ have a plain C interface; nvcc compiles them into
one shared library for sm_90a at first use, into
minialign_tpu_torch/build/ (git-ignored), and ctypes loads it. Pointers
and the stream go in as c_void_p. Every C entry point returns
cudaGetLastError() after its launch and the wrappers raise on non-zero.

LAUNCHES counts kernel launches per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
SOURCES = ("fill.cu", "gather.cu", "dtrace.cu")
LIB = os.path.join(BUILD, "libminialign_cuda.so")
ARCH = "arch=compute_90a,code=sm_90a"

LAUNCHES = {"fill": 0, "gather": 0, "dtrace": 0}
BUILD_LOG = ""        # nvcc's output of the last build (ptxas -v lines)

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    # name: argtypes (all return int = cudaError_t)
    "fill_launch": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "gather_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "dtrace_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P,
                      _P, _P, _I, _P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA "
                       "toolkit's bin/ on PATH)")


def build() -> str:
    """Compile csrc/*.cu into LIB unless it is newer than every source.
    Returns the library path; raises with nvcc's output on failure."""
    global BUILD_LOG
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    if os.path.exists(LIB) and os.path.getmtime(LIB) >= max(
            os.path.getmtime(s) for s in srcs):
        return LIB
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp] + srcs
    r = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, LIB)
    return LIB


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def count(kernel: str) -> None:
    """Add one launch of `kernel` (scheduler threads launch concurrently)."""
    with _lock:
        LAUNCHES[kernel] += 1


def reset_counts() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
