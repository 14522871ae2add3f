"""Copy of minialign_tpu/index/sketch.py for the port, unchanged apart from
this header (its imports are relative, so they resolve in this package).

(w,k)-minimizer sketch, bit-compatible with the reference.

Semantics (minialign.c:2349-2448):
  * canonical k-mer: km = min(k0, k1f) where k0 is the forward 2-bit
    k-mer and k1 the reverse complement; strand bit set when k1 < k0.
  * hash64(km, kx, mask) = (crc32c_u64(kx, kx) ^ km) & mask with
    mask = 4^k - 1 (minialign.c:2353, _mm_crc32_u64 semantics:
    accumulator = low 32 bits of kx, then 8 bytes LSB-first).
  * h = hash << 8 | in_window_index | strand << 7.
  * sliding window-min over w consecutive h values; an occurrence is
    emitted when the window min changes or the newest element equals
    the min (so exact repeats re-emit; ties resolve to the newest
    position, matching the reference's push rule `(v == h) | (v - u)`).

This module computes positions directly (the reference encodes them as
in-window indices and reconstructs in the drain, minialign.c:2831-2841;
the direct form is equivalent — see the base-advance invariant there).

Everything is vectorized numpy; the device (JAX) variant lives in
index/sketch_jax.py and is cross-checked against this one.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# CRC32-C (Castagnoli), matching SSE4.2 _mm_crc32_u64
# ---------------------------------------------------------------------------

_CRC_POLY = 0x82F63B78  # reflected CRC32-C polynomial


def _make_table() -> np.ndarray:
    t = np.empty(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CRC_POLY if (c & 1) else 0)
        t[i] = c
    return t


_CRC_TABLE = _make_table()


def crc32c_u64(crc: np.ndarray, val: np.ndarray) -> np.ndarray:
    """Vectorized _mm_crc32_u64: crc accumulator (low 32 bits used)
    updated with the 8 bytes of val, LSB first."""
    r = (np.asarray(crc, np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    v = np.asarray(val, np.uint64)
    for i in range(8):
        byte = ((v >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint32)
        r = (r >> np.uint32(8)) ^ _CRC_TABLE[(r ^ byte) & np.uint32(0xFF)]
    return r.astype(np.uint64)


def hash64(km: np.ndarray, kx: np.ndarray, mask: int) -> np.ndarray:
    return (crc32c_u64(kx, kx) ^ np.asarray(km, np.uint64)) & np.uint64(mask)


# ---------------------------------------------------------------------------
# k-mer streams
# ---------------------------------------------------------------------------

def kmer_stream(codes: np.ndarray, k: int):
    """Forward and reverse-complement k-mer integer streams.

    codes: (L,) 2-bit codes (N already squashed to 0 by the reader, as
    the reference's _encaf does). Returns (k0, k1) of length L-k+1.
    """
    codes = np.asarray(codes, np.uint64)
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return (np.empty(0, np.uint64),) * 2
    k0 = np.zeros(n, np.uint64)
    k1 = np.zeros(n, np.uint64)
    for i in range(k):
        k0 |= codes[i:n + i] << np.uint64(2 * (k - 1 - i))
        k1 |= (np.uint64(3) ^ codes[i:n + i]) << np.uint64(2 * i)
    return k0, k1


def hash_stream(codes: np.ndarray, k: int):
    """Per-position (hash, strand) for all k-mers. hash is the 2k-bit
    invertible hash; strand=1 when the reverse complement is smaller."""
    mask = (1 << (2 * k)) - 1
    k0, k1 = kmer_stream(codes, k)
    # tie (palindromic k-mer, even k only): the reference marks the
    # REVERSE strand (m = k0 < k1 ? 0 : 0x80, minialign.c:2396)
    strand = (k1 <= k0)
    km = np.where(strand, k1, k0)
    kx = np.where(strand, k0, k1)
    h = hash64(km, kx, mask)
    return h, strand


# ---------------------------------------------------------------------------
# sliding window-min minimizer selection
# ---------------------------------------------------------------------------

def sketch(codes: np.ndarray, k: int, w: int):
    """Minimizer occurrences of one sequence.

    Returns (hash, pos, strand) arrays: the minimizer hash (2k bits),
    the k-mer start position, and the strand bit. Ordered by emission
    (ascending position).
    """
    from .. import native
    if native.available():
        r = native.sketch_seq(codes, k, w)
        if r is not None:
            return r
    # the numpy fallback's k-mer bit math needs int64 codes
    codes = np.asarray(codes, np.int64)
    h, strand = hash_stream(codes, k)
    n = len(h)
    if n == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.uint8))

    # full 64-bit comparable value: hash<<8 | idx | strand<<7, exactly
    # the reference's packing (idx = position mod w)
    idx = (np.arange(n, dtype=np.uint64) % np.uint64(w))
    v = (h << np.uint64(8)) | idx | (strand.astype(np.uint64) << np.uint64(7))

    # sliding min over trailing w elements (windows clipped at the head,
    # matching the reference's UINT64_MAX-initialized r buffer)
    pad = w - 1
    vp = np.concatenate([np.full(pad, np.iinfo(np.uint64).max, np.uint64), v])
    sw = np.lib.stride_tricks.sliding_window_view(vp, w)       # (n, w)
    am = w - 1 - np.argmin(sw[:, ::-1], axis=1)  # last occurrence on ties
    vmin = sw[np.arange(n), am]
    pos_min = np.arange(n) - (w - 1) + am

    prev = np.concatenate([[np.uint64(0)], vmin[:-1]])
    emit = (vmin != prev) | (vmin == v)
    # ties between an older min and an identical new element resolve to
    # the newest position (the reference pushes h itself on v == h)
    pos = np.where(vmin == v, np.arange(n), pos_min)

    return (vmin[emit] >> np.uint64(8)).astype(np.uint64), \
        pos[emit].astype(np.int64), \
        ((vmin[emit] >> np.uint64(7)) & np.uint64(1)).astype(np.uint8)


def sketch_query(codes: np.ndarray, k: int, w: int):
    """Sketch of a query read: same as sketch() (used by seed collection,
    minialign.c:3454-3493)."""
    return sketch(codes, k, w)
