"""Build and load the port's CUDA kernels.

The sources in csrc/ have a plain C interface; at first use nvcc
compiles each of them for sm_90a, all at once, and links them into one
shared library in minialign_tpu_torch/build/ (git-ignored), which
ctypes loads. Pointers and the stream go in as c_void_p. Every C entry
point returns cudaGetLastError() after its launch and the wrappers
raise on non-zero.

LAUNCHES counts kernel launches per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels. TRACED_FILL_B lists the
problems of each traced fill launch (the launch size the fill and walk
kernels see on the main path), FUSED_SHAPES the problems, row lengths,
band width and tracing of each store-mode fill launch. With
$MINIALIGN_LAUNCH_LOG set to a directory, a process writes its
LAUNCHES there at exit
(launches.<pid>.json), so that a run whose kernels launch in worker
processes (the CLI's -tN) can count them (worker_launches).
"""

from __future__ import annotations

import atexit
import ctypes
import json
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
SOURCES = ("fill.cu", "gather.cu", "dtrace.cu", "lookup.cu", "sketch.cu",
           "probe_subint32.cu", "probe_lowprec.cu", "probe_bf16ops.cu",
           "probe_wordstream.cu")
HEADERS = ("probe_common.cuh",)
LIB = os.path.join(BUILD, "libminialign_cuda.so")
ARCH = "arch=compute_90a,code=sm_90a"
FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

# the mapper's kernels ("fused": a fill that reads its windows from the
# sequence stores, D2, counted as a fill too; "duo": the fill's duo
# epilogue, counted once a launch that runs it), the sharded index's
# lookup (parallel/), the device minimizer sketch (index/), then the
# step-mix probes P1-P4 (probes/), and the probes' launch floor, an empty
# kernel (probes/_common.launch_floor: kbench.py only)
LAUNCHES = {"fill": 0, "fused": 0, "gather": 0, "dtrace": 0, "duo": 0,
            "lookup": 0, "sketch": 0,
            "p1": 0, "p2": 0, "p3": 0, "p4": 0, "noop": 0}
TRACED_FILL_B: list[int] = []
FUSED_SHAPES: list[tuple] = []        # (B, La, Lb, W, trace)
BUILD_LOG = ""        # nvcc's output of the last build (ptxas -v lines)

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGS = {
    # name: argtypes (all return int = cudaError_t)
    "fill_launch": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                    _P],
    "fill_store_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _LL, _P],
    "gather_pair_launch": [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _P, _P,
                           _P],
    "dtrace_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _P,
                      _P, _P, _I, _P],
    "lookup_launch": [_P, _P, _P, _P, _P, _P, _I, _LL, _P, _LL, _P, _I, _I,
                      _P],
    "sketch_launch": [_P, _LL, _I, _I, _P, _P, _P, _P, _P],
    # the probes' entries end in (device index, stream)
    "p1_probe_launch": [_P, _P, _I, _I, _I, _I, _P, _I, _P],
    "p2_elementwise_launch": [_P, _P, _I, _I, _I, _I, _P, _I, _P],
    "p2_roll_concat_launch": [_P, _P, _I, _I, _I, _P, _I, _P],
    "p2_step_timer_launch": [_P, _P, _I, _I, _I, _P, _I, _P],
    "p3_run2_launch": [_P, _P, _I, _I, _I, _I, _P, _I, _P],
    "p3_timing_launch": [_P, _I, _I, _I, _P, _I, _P],
    "p4_var_shift_launch": [_P, _P, _I, _P, _I, _P],
    "p4_div10_launch": [_P, _I, _P, _I, _P],
    "p4_roll_in_carry_launch": [_P, _I, _I, _P, _I, _P],
    "p4_stream_launch": [_P, _P, _P, _I, _I, _P, _I, _P],
    "probe_noop_launch": [_P, _P, _I, _I, _I, _I, _P, _I, _P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA "
                       "toolkit's bin/ on PATH)")


def _run(cmd: list[str]) -> tuple[int, str]:
    r = subprocess.run(cmd, capture_output=True, text=True)
    return r.returncode, r.stdout + r.stderr


def build() -> str:
    """Compile csrc/*.cu into LIB unless it is newer than every source
    and header: one nvcc per source, all started together, then one
    link. Returns the library path; raises with nvcc's output on
    failure."""
    global BUILD_LOG
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    deps = srcs + [os.path.join(CSRC, h) for h in HEADERS]
    if os.path.exists(LIB) and os.path.getmtime(LIB) >= max(
            os.path.getmtime(s) for s in deps):
        return LIB
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        with ThreadPoolExecutor(len(srcs)) as ex:
            done = list(ex.map(_run, ([nvcc, *FLAGS, "-c", src, "-o", obj]
                                      for src, obj in zip(srcs, objs))))
        BUILD_LOG = "".join(log for _, log in done)
        bad = [s for s, (rc, _) in zip(SOURCES, done) if rc != 0]
        if bad:
            raise RuntimeError(f"nvcc failed on {bad}:\n{BUILD_LOG}")
        so = os.path.join(tmp, "lib.so")
        rc, log = _run([nvcc, "-shared", "-o", so] + objs)
        BUILD_LOG += log
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{BUILD_LOG}")
        os.replace(so, LIB)
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


def count_traced_fill(batch: int) -> None:
    with _lock:
        TRACED_FILL_B.append(batch)


def count_fused(shape: tuple) -> None:
    with _lock:
        FUSED_SHAPES.append(shape)


def reset_counts() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        TRACED_FILL_B.clear()
        FUSED_SHAPES.clear()


def _log_launches(log_dir: str) -> None:
    with open(os.path.join(log_dir, f"launches.{os.getpid()}.json"),
              "w") as f:
        json.dump(LAUNCHES, f)


def worker_launches(log_dir: str) -> dict[str, int]:
    """The launches, by kernel, of every process that logged to log_dir
    ($MINIALIGN_LAUNCH_LOG), summed."""
    out = dict.fromkeys(LAUNCHES, 0)
    for name in os.listdir(log_dir):
        if name.startswith("launches."):
            with open(os.path.join(log_dir, name)) as f:
                for k, v in json.load(f).items():
                    out[k] += v
    return out


if os.environ.get("MINIALIGN_LAUNCH_LOG"):
    atexit.register(_log_launches, os.environ["MINIALIGN_LAUNCH_LOG"])


def check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
