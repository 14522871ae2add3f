"""Copy of minialign_tpu/ksort.py for the port, unchanged apart from
this header (its imports are relative, so they resolve in this package).

ksort-compatible radix sort permutations.

The reference orders everything with ksort.h's in-place MSD
(American-flag) radix sort keyed on a PREFIX of each record
(sort_key_128x = u64[0] of 16-byte records, sort_key_64x = u32[0] of
8-byte records; minialign.c:203-206). Equal-key records therefore end
up in the deterministic — but NOT stable — permutation that algorithm
produces, and several observable behaviors depend on it: multi-hit
minimizer list order, the seed order feeding the greedy chainer, the
pick among equal-pdiff rescue seeds, and the record order of
equal-score results. These functions reproduce the exact permutation
(RS_MIN_SIZE=64 insertion-sort fallback included); the native C
version in native/minialign_native.cpp is bit-equal and preferred.

Algorithm attribution: the reproduced algorithm is klib's
KRADIX_SORT_INIT (https://github.com/attractivechaos/klib ksort.h,
MIT license, (c) Attractive Chaos), which the reference vendors as
ksort.h.

Returns order indices (sort by taking arr[order]).
"""

from __future__ import annotations

import numpy as np

_RS_MIN = 64


def _insertsort(keys, order, lo, hi):
    for i in range(lo + 1, hi):
        if keys[i] < keys[i - 1]:
            tk, to = keys[i], order[i]
            j = i
            while j > lo and tk < keys[j - 1]:
                keys[j] = keys[j - 1]
                order[j] = order[j - 1]
                j -= 1
            keys[j], order[j] = tk, to


def _rs_sort(keys, order, lo, hi, s):
    # one American-flag pass over keys[lo:hi] on byte `s`
    cnt = [0] * 256
    for i in range(lo, hi):
        cnt[(keys[i] >> s) & 255] += 1
    be = [0] * 256          # bucket write ptr
    be_end = [0] * 256      # bucket end
    acc = lo
    for d in range(256):
        be[d] = acc
        acc += cnt[d]
        be_end[d] = acc
    bb = be[:]              # bucket begin (for recursion ranges)
    d = 0
    while d < 256:
        if be[d] != be_end[d]:
            ld = (keys[be[d]] >> s) & 255
            if ld != d:
                tk, to = keys[be[d]], order[be[d]]
                while True:
                    j = be[ld]
                    keys[j], tk = tk, keys[j]
                    order[j], to = to, order[j]
                    be[ld] += 1
                    ld = (tk >> s) & 255
                    if ld == d:
                        break
                keys[be[d]], order[be[d]] = tk, to
                be[d] += 1
            else:
                be[d] += 1
        else:
            d += 1
    if s:
        s2 = s - 8 if s > 8 else 0
        for d in range(256):
            b0, e0 = bb[d], be_end[d]
            if e0 - b0 > _RS_MIN:
                _rs_sort(keys, order, b0, e0, s2)
            elif e0 - b0 > 1:
                _insertsort(keys, order, b0, e0)


def _ks_radix(keys_in, key_bytes):
    n = len(keys_in)
    keys = [int(k) for k in keys_in]
    order = list(range(n))
    if n <= _RS_MIN:
        _insertsort(keys, order, 0, n)
    else:
        _rs_sort(keys, order, 0, n, key_bytes * 8 - 8)
    return np.asarray(order, np.int64)


def ks_radix128(keys: np.ndarray) -> np.ndarray:
    """radix_sort_128x permutation (u64 keys)."""
    from . import native
    if native.available():
        r = native.ks_radix128(np.asarray(keys, np.uint64))
        if r is not None:
            return r
    return _ks_radix(np.asarray(keys, np.uint64), 8)


def ks_radix64(keys: np.ndarray) -> np.ndarray:
    """radix_sort_64x permutation (u32 keys)."""
    from . import native
    if native.available():
        r = native.ks_radix64(np.asarray(keys, np.uint32))
        if r is not None:
            return r
    return _ks_radix(np.asarray(keys, np.uint32), 4)
