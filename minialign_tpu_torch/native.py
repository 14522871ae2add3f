"""ctypes bindings for the native host runtime (csrc/host/*.cpp).

Copy of minialign_tpu/native.py for the port. Only where the library
comes from differs: csrc/host/minialign_native.cpp is a copy of
native/minialign_native.cpp, and at first use g++ builds it into
build/libminialign_host.so (git-ignored), again whenever the source is
newer. The device kernels own the DP compute; the native library owns
the host hot paths the reference implements in C (traceback walk,
CIGAR/MD formatting, FASTA/FASTQ parsing). Every entry point has a pure
Python fallback, selected when the library is unavailable or
MINIALIGN_NO_NATIVE is set.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "host", "minialign_native.cpp")
_SO = os.path.join(_PKG, "build", "libminialign_host.so")
# native/Makefile's flags; -march=native only where the compiler has it
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")

_lib = None
_tried = False
_malloc_tuned = False
# per-thread grow-only scratch: sketching currently runs on one worker
# thread, but keep the invariant structural so a widened -t pipeline
# cannot silently corrupt minimizer streams
_sketch_tls = threading.local()


def tune_malloc() -> bool:
    """Keep large allocations on the (faulted-once) heap instead of
    per-allocation mmap/munmap. On lazily-backed VMs fresh page faults
    can run ~1000x slower than touched memory (measured 8 MB/s vs
    5.6 GB/s on this class of host), and numpy's large arrays default
    to mmap-per-allocation — so every big temporary pays the fault
    cost again. glibc-only; no-op elsewhere. Returns True if applied.

    The reference's analogue is its lmm arena allocator
    (minialign.c lmm.h usage): allocate once, reuse forever."""
    global _malloc_tuned
    if _malloc_tuned:
        return True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        ok = libc.mallopt(M_MMAP_THRESHOLD, 1 << 31)
        ok &= libc.mallopt(M_TRIM_THRESHOLD, 1 << 31)
        _malloc_tuned = bool(ok)
    except Exception:
        _malloc_tuned = False
    return _malloc_tuned


class _TraceParams(ctypes.Structure):
    _fields_ = [("W", ctypes.c_int32), ("model", ctypes.c_int32),
                ("gi", ctypes.c_int32), ("ge", ctypes.c_int32),
                ("gfa", ctypes.c_int32), ("gfb", ctypes.c_int32),
                ("gfa_eff", ctypes.c_int32), ("gfb_eff", ctypes.c_int32)]


class _TraceOut(ctypes.Structure):
    _fields_ = [("plen", ctypes.c_int64), ("n_ops", ctypes.c_int64),
                ("dcnt", ctypes.c_int64),
                ("agcnt", ctypes.c_int64), ("bgcnt", ctypes.c_int64),
                ("gap_penalty", ctypes.c_int64),
                ("e_pen", ctypes.c_int64), ("status", ctypes.c_int32)]


def _build_host() -> None:
    """g++ the host library into a temporary file beside _SO, then
    rename it, so concurrent builders never load a half-written file."""
    cxx = os.environ.get("CXX", "g++")
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    march = subprocess.run([cxx, "-march=native", "-E", "-x", "c++",
                            os.devnull], capture_output=True).returncode
    flags = list(_CXXFLAGS) + (["-march=native"] if march == 0 else [])
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        subprocess.run([cxx, *flags, "-shared", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("MINIALIGN_NO_NATIVE"):
        return None
    # rebuild when the library is missing or older than its source, as
    # native/Makefile does: a stale library whose symbol set predates
    # the bindings would raise AttributeError below
    try:
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _build_host()
    except (OSError, subprocess.SubprocessError):
        if not os.path.exists(_SO):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.trace_one.restype = ctypes.c_int
    lib.trace_one.argtypes = [
        u32p, u32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(_TraceParams),
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(_TraceOut)]
    lib.cigar_rle.restype = ctypes.c_int64
    lib.cigar_rle.argtypes = [ctypes.c_char_p, ctypes.c_int64, u32p]
    lib.ks_radix128.restype = None
    lib.ks_radix128.argtypes = [u64p, ctypes.c_int64, u64p]
    lib.ks_radix64.restype = None
    lib.ks_radix64.argtypes = [u32p, ctypes.c_int64, u32p]
    lib.idx_bucket_sort.restype = None
    lib.idx_bucket_sort.argtypes = [u64p, ctypes.c_int64,
                                    ctypes.c_int, u64p]
    lib.idx_scatter.restype = None
    lib.idx_scatter.argtypes = [u64p, u32p, u32p, ctypes.c_int64,
                                ctypes.c_int, i64p, u32p, u32p, u32p]
    lib.idx_sort_count.restype = ctypes.c_int64
    lib.idx_sort_count.argtypes = [u32p, u32p, u32p, i64p,
                                   ctypes.c_int64, ctypes.c_int32]
    lib.idx_emit.restype = None
    lib.idx_emit.argtypes = [u32p, i64p, ctypes.c_int64, ctypes.c_int,
                             u64p, u32p, i64p]
    lib.parse_rv.restype = ctypes.c_int64
    lib.parse_rv.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_int64, u32p, ctypes.c_int64]
    lib.rv_cigar.restype = ctypes.c_int64
    lib.rv_cigar.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_char_p,
                             ctypes.c_int64]
    lib.md_walk.restype = ctypes.c_int64
    lib.md_walk.argtypes = [ctypes.c_char_p, ctypes.c_int64, i8p, i8p,
                            ctypes.c_char_p]
    try:
        lib.parse_fastx.restype = ctypes.c_int64
        lib.parse_fastx.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int64, i64p, ctypes.c_int64,
                                    i8p, ctypes.c_int64]
        # round-4/5 symbols: bind last so a stale library that somehow
        # survived the make above degrades to the Python paths instead
        # of crashing mapping
        lib.rle_paths
        lib.collect_seeds_c
    except AttributeError:
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def trace_one(p, W: int, masks: np.ndarray, dirs: np.ndarray,
              ihead0: int, score: int, ai: int, bj: int):
    """Native traceback walk. Returns (path, path_rev, dcnt, agcnt,
    bgcnt, gap_penalty, e_pen, ops_rev) or None (out-of-band) — the
    same contract as dp/traceback.traceback_one's core walk."""
    lib = _load()
    masks = np.ascontiguousarray(masks, np.uint32)
    dirs = np.ascontiguousarray(dirs, np.uint32)
    tp = _TraceParams(W=W, model=p.model, gi=p.gi, ge=p.ge,
                      gfa=p.gfa, gfb=p.gfb,
                      gfa_eff=p.gfa_eff, gfb_eff=p.gfb_eff)
    out = _TraceOut()
    cap = 2 * (int(ai) + int(bj)) + 2
    fwd = ctypes.create_string_buffer(cap)
    rev = ctypes.create_string_buffer(cap)
    opsb = ctypes.create_string_buffer(cap)
    lib.trace_one(masks, dirs, np.int32(dirs.shape[0]),
                  np.int32(ihead0), score, ai, bj,
                  ctypes.byref(tp), fwd, rev, opsb, ctypes.byref(out))
    if out.status != 0:
        return None
    n = out.plen
    return (fwd.raw[:n].decode("latin1"), rev.raw[:n].decode("latin1"),
            out.dcnt, out.agcnt, out.bgcnt, out.gap_penalty, out.e_pen,
            opsb.raw[:out.n_ops].decode("latin1"))


def cigar_rle(path: str) -> np.ndarray | None:
    """(count<<4 | op) uint32 runs with op 0=M 1=I 2=D."""
    lib = _load()
    if lib is None:
        return None
    b = path.encode("latin1")
    out = np.empty(len(b) + 1, np.uint32)
    n = lib.cigar_rle(b, len(b), out)
    return out[:n]


def ks_radix128(keys: np.ndarray) -> np.ndarray | None:
    """The reference's radix_sort_128x permutation (ksort.h via
    minialign.c:203): returns order indices such that keys[order] is
    sorted with ksort's exact (unstable) equal-key permutation."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    out = np.empty(len(keys), np.uint64)
    lib.ks_radix128(keys, len(keys), out)
    return out.astype(np.int64)


def idx_bucket_sort(h: np.ndarray, b: int) -> np.ndarray | None:
    """Whole index-build ordering in one call: stable counting sort
    into 2^b buckets by the low hash bits, then ksort's exact 128x
    permutation per bucket keyed on hrem = h >> b (mm_idx_drain +
    mm_idx_count_occ, minialign.c:2837+2882)."""
    lib = _load()
    if lib is None:
        return None
    h = np.ascontiguousarray(h, np.uint64)
    out = np.empty(len(h), np.uint64)
    lib.idx_bucket_sort(h, len(h), b, out)
    return out.astype(np.int64)


def idx_scatter(h, pos, rid, b, cursors, hs, vp, vr) -> bool:
    """Append one sketched chunk at the per-bucket cursors (arrival
    order = mm_idx_drain's push order, minialign.c:2837)."""
    lib = _load()
    if lib is None:
        return False
    lib.idx_scatter(np.ascontiguousarray(h, np.uint64),
                    np.ascontiguousarray(pos, np.uint32),
                    np.ascontiguousarray(rid, np.uint32),
                    len(h), b, cursors, hs, vp, vr)
    return True


def idx_sort_count(hs, vp, vr, boff) -> int | None:
    """Per-bucket ksort-exact sort on hrem applied in place to the
    three SoA arrays; returns the distinct-key total. Buckets are
    independent, so MINIALIGN_BUILD_THREADS > 1 partitions them across
    worker threads (byte-identical output; the reference sorts buckets
    on its pt pool the same way, minialign.c:2868-2898)."""
    lib = _load()
    if lib is None:
        return None
    nthreads = int(os.environ.get(
        "MINIALIGN_BUILD_THREADS", str(min(os.cpu_count() or 1, 8))))
    return int(lib.idx_sort_count(hs, vp, vr, boff, len(boff) - 1,
                                  max(nthreads, 1)))


def idx_emit(hs, boff, b, keys, offsets, bkt_off) -> bool:
    lib = _load()
    if lib is None:
        return False
    lib.idx_emit(hs, boff, len(boff) - 1, b, keys, offsets, bkt_off)
    return True


def ks_radix64(keys: np.ndarray) -> np.ndarray | None:
    """radix_sort_64x permutation (u32 keys)."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint32)
    out = np.empty(len(keys), np.uint32)
    lib.ks_radix64(keys, len(keys), out)
    return out.astype(np.int64)


def parse_rv(upath: str, off: int, plen: int) -> list | None:
    """Display-order cigar tokens [(count, op)] via the gaba reverse
    parse (see io/sam.py parse_path_rv and the C implementation)."""
    lib = _load()
    if lib is None:
        return None
    b = upath.encode("latin1")
    out = np.empty(plen + 2, np.uint32)
    n = lib.parse_rv(b, off, plen, out, len(out))
    if n < 0:
        return None
    opc = "MID"
    return [(int(w) >> 4, opc[w & 15]) for w in out[:n]]


def rv_cigar(upath: str, off: int, plen: int) -> str | None:
    """CIGAR ASCII directly from the up-space path (parse_rv fused
    with number formatting — the Python tuple list + per-token
    f-strings were a printer hot spot)."""
    lib = _load()
    if lib is None:
        return None
    b = upath.encode("latin1")
    cap = 2 * plen + 16
    out = ctypes.create_string_buffer(cap)
    n = lib.rv_cigar(b, off, plen, out, cap)
    if n < 0:
        return None
    return out.raw[:n].decode("latin1")


def md_walk(path: str, rcodes: np.ndarray, qcodes: np.ndarray) -> str | None:
    lib = _load()
    if lib is None:
        return None
    b = path.encode("latin1")
    rc = np.ascontiguousarray(rcodes, np.int8)
    qc = np.ascontiguousarray(qcodes, np.int8)
    out = ctypes.create_string_buffer(2 * len(b) + 16)
    n = lib.md_walk(b, len(b), rc, qc, out)
    return out.raw[:n].decode("latin1")


def parse_fastx(data: bytes, keep_qual: bool, min_len: int):
    """Returns (recs (n,8) int64, codes int8 buffer) or None.
    Row layout: name_off, name_len, comment_off, comment_len,
    seq_off, seq_len, qual_off, qual_len (offsets into codes for
    seq/qual, into data for name/comment)."""
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(data, np.uint8)
    max_recs = max(len(data) // 8, 16)
    recs = np.empty((max_recs, 8), np.int64)
    codes = np.empty(len(data) + 16, np.int8)
    n = lib.parse_fastx(arr, len(arr), int(keep_qual), min_len,
                        recs.reshape(-1), max_recs, codes, len(codes))
    if n < 0:
        return None
    return recs[:n], codes


def _bind_sketch(lib):
    if hasattr(lib, "_sketch_bound"):
        return
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.sketch_seq.restype = ctypes.c_int64
    lib.sketch_seq.argtypes = [i8p, ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_int64,
                               u64p, i64p, u8p]
    lib._sketch_bound = True


def sketch_seq(codes: np.ndarray, k: int, w: int):
    """(w,k)-minimizer sketch (mm_sketch parity); None if unavailable."""
    lib = _load()
    if lib is None or w > 64:
        return None
    _bind_sketch(lib)
    c = np.ascontiguousarray(np.asarray(codes) & 3, np.int8)
    L = len(c)
    # emission density is ~2/(w+1); start with 4x headroom and retry
    # on overflow — L-sized outputs cost real time on lazily-backed
    # hosts (fresh page faults, see tune_malloc). Reuse one scratch
    # set across calls (grow-only; callers get copies).
    cap = max(min(L, 8 * L // w + 1024), 16)
    scr = getattr(_sketch_tls, "scr", None)
    if scr is None:
        scr = _sketch_tls.scr = {}
    while True:
        if scr.get("cap", 0) < cap:
            scr["h"] = np.empty(cap, np.uint64)
            scr["pos"] = np.empty(cap, np.int64)
            scr["st"] = np.empty(cap, np.uint8)
            scr["cap"] = cap
        n = lib.sketch_seq(c, L, k, w, scr["cap"], scr["h"],
                           scr["pos"], scr["st"])
        if n >= 0:
            return (scr["h"][:n].copy(), scr["pos"][:n].copy(),
                    scr["st"][:n].copy())
        cap = min(max(L, 1), scr["cap"] * 4)


def _bind_rle(lib):
    if hasattr(lib, "_rle_bound"):
        return
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rle_paths.restype = ctypes.c_int64
    lib.rle_paths.argtypes = [u8p, ctypes.c_int64, u8p, u8p, u8p,
                              ctypes.c_int64, i64p]
    lib._rle_bound = True


_rle_tls = threading.local()


def rle_paths(ent: np.ndarray):
    """Expand backward RLE entries into (path, path_rev, ops_rev)
    strings (the device-walk harvest's string forms); None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    _bind_rle(lib)
    ent = np.ascontiguousarray(ent, np.uint8)
    scr = getattr(_rle_tls, "scr", None)
    if scr is None:
        scr = _rle_tls.scr = {"cap": 0}
    cap = max(2 * 64 * len(ent) + 64, 4096)
    if scr["cap"] < cap:
        scr["fwd"] = np.empty(cap, np.uint8)
        scr["rev"] = np.empty(cap, np.uint8)
        scr["tok"] = np.empty(cap, np.uint8)
        scr["cap"] = cap
    nops = np.zeros(1, np.int64)
    total = lib.rle_paths(ent, len(ent), scr["fwd"], scr["rev"],
                          scr["tok"], scr["cap"], nops)
    if total < 0:
        return None
    n = int(nops[0])
    return (scr["fwd"][:total].tobytes().decode(),
            scr["rev"][:total].tobytes().decode(),
            scr["tok"][:n].tobytes().decode())


def _bind_collect(lib):
    if hasattr(lib, "_collect_bound"):
        return
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.collect_seeds_c.restype = ctypes.c_int64
    lib.collect_seeds_c.argtypes = [
        i8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        u64p, ctypes.c_int64, i64p, ctypes.c_int32,
        u32p, u32p, u32p, ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, ctypes.c_int64,
        i64p, ctypes.c_int64, i64p]
    lib._collect_bound = True


_collect_tls = threading.local()


def collect_seeds(mi, qcodes: np.ndarray):
    """Fused round-0 seed collection: sketch + bucket-CSR lookup +
    mm_expand in one native pass (mm_collect_seed parity,
    minialign.c:3454-3493). Returns (upos, vpos, rid, resc) int32x3 +
    (m, 3) int64, or None when unavailable (no native lib, legacy
    index layout, or w > 64) — callers fall back to the numpy path."""
    lib = _load()
    if lib is None or getattr(mi, "bkt_off", None) is None or mi.w > 64:
        return None
    if mi.offsets.dtype != np.uint32 or mi.vals_pos.dtype != np.uint32 \
            or mi.vals_rid.dtype != np.uint32:
        return None
    _bind_collect(lib)
    c = np.ascontiguousarray(np.asarray(qcodes) & 3, np.int8)
    L = len(c)
    scr = getattr(_collect_tls, "scr", None)
    if scr is None:
        scr = _collect_tls.scr = {"cap_s": 0, "cap_r": 0}
    cap_s = max(16 * L // max(mi.w, 1) + 4096, 1024)
    cap_r = max(4 * L // max(mi.w, 1) + 1024, 256)
    nresc = np.zeros(1, np.int64)
    keys = mi.keys
    bkt_off = mi.bkt_off
    while True:
        if scr["cap_s"] < cap_s:
            scr["up"] = np.empty(cap_s, np.int32)
            scr["vp"] = np.empty(cap_s, np.int32)
            scr["rd"] = np.empty(cap_s, np.int32)
            scr["cap_s"] = cap_s
        if scr["cap_r"] < cap_r:
            scr["resc"] = np.empty((cap_r, 3), np.int64)
            scr["cap_r"] = cap_r
        ns = lib.collect_seeds_c(
            c, L, mi.k, mi.w, keys, len(keys), bkt_off, mi.b,
            mi.offsets, mi.vals_pos, mi.vals_rid,
            int(mi.max_occ), int(mi.occ[0]),
            scr["up"], scr["vp"], scr["rd"], scr["cap_s"],
            scr["resc"].reshape(-1), scr["cap_r"], nresc)
        if ns >= 0:
            nr = int(nresc[0])
            return (scr["up"][:ns].copy(), scr["vp"][:ns].copy(),
                    scr["rd"][:ns].copy(), scr["resc"][:nr].copy())
        if ns == -1:
            cap_s = scr["cap_s"] * 4
        else:
            cap_r = scr["cap_r"] * 4


def _bind_chain(lib):
    if hasattr(lib, "_chain_bound"):
        return
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.chain_seeds_c.restype = ctypes.c_int64
    lib.chain_seeds_c.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                  i64p, u8p, ctypes.c_int64,
                                  i64p, ctypes.c_int64]
    lib._chain_bound = True


def chain_seeds(seeds: np.ndarray, twlen: int, lens: np.ndarray,
                circ: np.ndarray):
    """Greedy seed chaining (+circularize). Returns (n, 3) int64 rows
    [plen, root_sid, leaf_sid] in creation order (consumed chains have
    plen = -1), or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    _bind_chain(lib)
    seeds = np.ascontiguousarray(seeds, np.int64)
    n = len(seeds)
    lens = np.ascontiguousarray(lens, np.int64)
    circ = np.ascontiguousarray(circ, np.uint8)
    out = np.empty((max(n, 1), 3), np.int64)
    cnt = lib.chain_seeds_c(seeds.reshape(-1), n, twlen, lens, circ,
                            len(lens), out.reshape(-1), len(out))
    if cnt < 0:
        return None
    return out[:cnt]
