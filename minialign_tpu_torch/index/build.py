"""Copy of minialign_tpu/index/build.py for the port, unchanged apart from
this header and build_index's spans (stats.py): `index.sketch` around
the sketch passes, `index.sort` around the bucket sort and the table's
assembly (its imports are relative, so they resolve in this package).

Minimizer reference index.

TPU-first redesign of the reference's two-stage Robinhood hash
(minialign.c:2450-2997): instead of 2^b buckets of open-addressing
tables with pointer-linked value arrays, the index is a flat sorted
key array + CSR offsets + a value array — directly usable on device
(lookup = vectorized binary search / gather) and trivially shardable
by hash range across hosts.

Equivalences kept:
  * same minimizer set (index/sketch.py is bit-compatible).
  * values are (pos, rid<<1|strand) pairs like mm_mini_t
    (minialign.c:2661-2664).
  * occurrence thresholds occ[i] = (k-th smallest of per-key counts at
    quantile 1-frq[i]) + 1 (minialign.c:2984-2988).
  * keys with count > occ[-1] are dropped from lookups (the reference
    drops them at build, minialign.c:2927; we keep them stored but
    filtered, which is observationally equal and keeps the array
    shardable without re-counting).

Hit ordering within a key is (pos, rid) ascending; the reference's
order is its radix sort's equal-key order (insertion order for the
stable insertion-sorted small buckets). Divergence only affects seed
tie-breaking order; tracked for the SAM-parity pass.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .. import stats
from ..params import IndexParams
from .sketch import sketch


@dataclasses.dataclass
class MMIndex:
    k: int
    w: int
    occ: np.ndarray          # (n_frq,) uint32 occurrence thresholds
    frq: tuple
    # reference sequences
    names: list
    lens: np.ndarray         # (n_seq,) int64
    circular: np.ndarray     # (n_seq,) uint8
    codes: list              # list of (L,) int8 2-bit code arrays
    # minimizer table
    keys: np.ndarray         # (K,) uint64 distinct hashes — bucket-
                             # major (ascending within each 2^b low-
                             # bit bucket) when bkt_off is set, else
                             # globally sorted (legacy layout)
    offsets: np.ndarray      # (K+1,) uint32/int64 CSR offsets
    vals_pos: np.ndarray     # (V,) uint32 k-mer start positions
    vals_rid: np.ndarray     # (V,) uint32 (sid<<1 | strand)
    # two-stage layout (the reference's own design, minialign.c:2693):
    # bkt_off[j] .. bkt_off[j+1] = keys of first-stage bucket j
    b: int = 14
    bkt_off: np.ndarray | None = None

    @property
    def n_seq(self) -> int:
        return len(self.names)

    @property
    def max_occ(self) -> int:
        return int(self.occ[-1])

    def _dir_table(self):
        """First-stage direct-indexed bucket table (the reference's
        2^b bucket split, minialign.c:2953, rebuilt as CSR heads over
        the sorted keys): narrows each query to a handful of keys so a
        lookup pays ~2 cache misses instead of a 20-level binary
        search over the full key array (3 ms -> ~0.4 ms per read on
        1M-key indexes)."""
        t = getattr(self, "_dir", None)
        if t is None:
            nk = len(self.keys)
            kb = int(self.keys[-1]).bit_length() if nk else 1
            b = min(max(nk.bit_length(), 10), 22, kb)
            s = max(kb - b, 0)
            heads = np.bincount((self.keys >> np.uint64(s)).astype(
                np.int64), minlength=(1 << b) + 1)
            heads = np.concatenate(
                [[0], np.cumsum(heads, dtype=np.int64)])
            t = self._dir = (np.uint64(s), heads, (1 << b) - 1)
        return t

    def lookup(self, h: np.ndarray):
        """Batched lookup: returns (start, count) per query hash; count=0
        for missing keys. Two-stage: the low-b-bit bucket table (the
        reference's first stage) narrows each query to a handful of
        keys, then a vectorized lower_bound finds the key — ~2 cache
        misses per query instead of a 20-level global binary search."""
        h = np.asarray(h, np.uint64)
        if len(self.keys) and len(h):
            if self.bkt_off is not None:
                j = (h & np.uint64((1 << self.b) - 1)).astype(np.int64)
                lo = self.bkt_off[j]
                hi = self.bkt_off[j + 1]
            else:               # legacy globally-sorted key table
                s, heads, jmask = self._dir_table()
                j = np.minimum((h >> s).astype(np.int64), jmask)
                lo = heads[j]
                hi = heads[j + 1]
            # vectorized lower_bound within each bucket
            while True:
                live = lo < hi
                if not live.any():
                    break
                mid = (lo + hi) >> 1
                less = self.keys[np.minimum(mid, len(self.keys) - 1)] < h
                lo = np.where(live & less, mid + 1, lo)
                hi = np.where(live & ~less, mid, hi)
            idx = lo
        else:
            idx = np.searchsorted(self.keys, h)
        idx_c = np.minimum(idx, len(self.keys) - 1) if len(self.keys) else idx
        found = np.zeros(len(h), bool) if len(self.keys) == 0 else \
            (self.keys[idx_c] == h) & (idx < len(self.keys))
        off = self.offsets
        start = np.where(
            found, off[np.minimum(idx, len(off) - 2)].astype(np.int64), 0)
        cnt = np.where(
            found,
            off[np.minimum(idx + 1, len(off) - 1)].astype(np.int64)
            - start, 0)
        return start.astype(np.int64), cnt.astype(np.int64)

    def _arrays(self, prefix: str = "") -> dict:
        d = {
            "meta": np.asarray([self.k, self.w, len(self.occ)], np.int64),
            "occ": self.occ, "frq": np.asarray(self.frq, np.float64),
            "names": np.asarray(self.names, dtype=object),
            "lens": self.lens, "circular": self.circular,
            "keys": self.keys, "offsets": self.offsets,
            "vals_pos": self.vals_pos, "vals_rid": self.vals_rid,
        }
        if self.bkt_off is not None:
            d["bmeta"] = np.asarray([self.b], np.int64)
            d["bkt_off"] = self.bkt_off
        d.update({f"seq{i}": c for i, c in enumerate(self.codes)})
        return {prefix + k: v for k, v in d.items()}

    @classmethod
    def _from_arrays(cls, z, prefix: str = "") -> "MMIndex":
        meta = z[prefix + "meta"]
        n_seq = len(z[prefix + "lens"])
        return cls(
            k=int(meta[0]), w=int(meta[1]),
            occ=z[prefix + "occ"], frq=tuple(z[prefix + "frq"]),
            names=list(z[prefix + "names"]), lens=z[prefix + "lens"],
            circular=z[prefix + "circular"],
            codes=[z[f"{prefix}seq{i}"] for i in range(n_seq)],
            keys=z[prefix + "keys"], offsets=z[prefix + "offsets"],
            vals_pos=z[prefix + "vals_pos"],
            vals_rid=z[prefix + "vals_rid"],
            b=int(z[prefix + "bmeta"][0]) if prefix + "bmeta" in z
            else 14,
            bkt_off=z[prefix + "bkt_off"] if prefix + "bkt_off" in z
            else None,
        )

    def save(self, path: str) -> None:
        """Serialize as a flat array bundle (.mai.npz — the reference's
        .mai role: minialign.c:3040-3169)."""
        save_blocks(path, [self])

    @classmethod
    def load(cls, path: str) -> "MMIndex":
        return load_blocks(path)[0]


def save_blocks(path: str, blocks: list) -> None:
    """Serialize a multi-block index file: the reference's main_index
    appends one mm_idx_dump blob per positional file into one .mai
    (minialign.c:6308-6336); here one npz holds b{j}_-prefixed array
    bundles."""
    d = {"n_blocks": np.asarray([len(blocks)], np.int64)}
    for j, mi in enumerate(blocks):
        d.update(mi._arrays(prefix=f"b{j}_"))
    np.savez_compressed(path, **d)


def load_blocks(path: str) -> list:
    z = np.load(path, allow_pickle=True)
    if "n_blocks" not in z:            # legacy single-block file
        return [MMIndex._from_arrays(z)]
    return [MMIndex._from_arrays(z, prefix=f"b{j}_")
            for j in range(int(z["n_blocks"][0]))]


def build_index(params: IndexParams, names: Sequence[str],
                codes: Sequence[np.ndarray],
                circular: Sequence[bool] | None = None) -> MMIndex:
    """Build the index from 2-bit-coded reference sequences.

    Bucket-major layout (the reference's own two-stage design,
    minialign.c:2693-2997): minimizers live in 2^b first-stage buckets
    keyed by the LOW hash bits; within a bucket, keys ascend (= ksort
    of hrem = h >> b) and each key's hits keep ksort's exact equal-key
    permutation of the arrival order. The native path streams in two
    sketch passes (count, then scatter straight into the final value
    arrays) and sorts bucket-by-bucket, so peak memory is the FINAL
    index plus one u32 hrem array — no global permutation gathers
    (round 2 peaked at 24.5 GB/Gb; this is ~12 bytes/minimizer)."""
    k, w = params.k, params.w
    circ = np.asarray(
        [params.circular_all or (n in set(params.circular))
         for n in names] if circular is None else list(circular), np.uint8)

    b = int(getattr(params, "b", 14))
    nbkt = 1 << b
    mask = np.uint64(nbkt - 1)

    def _prep(sid):
        # int8 all the way to the sketcher: the int64 widening cost 8x
        # the bytes for nothing (the native sketch takes int8; the
        # numpy fallback widens internally)
        arr = np.asarray(codes[sid], np.int8) & 3
        if circ[sid]:
            # circular "nori-shiro" tail wrap (mm_sketch_cap,
            # minialign.c:2436-2443 via mm_idx_worker:2795-2797): the
            # sketch state machine is fed min(len, w) more bases from
            # the sequence head, which equals sketching the extended
            # stream seq + seq[:min(len, w)]; emitted positions
            # continue past len (handled by mm_search_load_pos's
            # over-end adjustment on the query side)
            arr = np.concatenate([arr, arr[:min(len(arr), w)]])
        return arr

    from .. import native
    stream = native.available() and 0 < (2 * k - b) <= 32

    sp = stats.begin("index.sketch") if stats.ON else None
    if stream:
        # pass 1: per-bucket counts only (triples discarded — the
        # second sketch pass is far cheaper than holding them)
        counts = np.zeros(nbkt, np.int64)
        total = 0
        for sid in range(len(codes)):
            h, _, _ = sketch(_prep(sid), k, w)
            counts += np.bincount((h & mask).astype(np.int64),
                                  minlength=nbkt)
            total += len(h)
        boff = np.zeros(nbkt + 1, np.int64)
        np.cumsum(counts, out=boff[1:])
        del counts
        # pass 2: scatter each chunk straight into bucket extents of
        # the FINAL value arrays (vp/vr become vals_pos/vals_rid)
        hs = np.empty(total, np.uint32)      # hrem per entry
        vp = np.empty(total, np.uint32)
        vr = np.empty(total, np.uint32)
        cursors = boff[:-1].copy()
        for sid in range(len(codes)):
            h, pos, strand = sketch(_prep(sid), k, w)
            rid = ((sid << 1) | strand.astype(np.uint32)) \
                .astype(np.uint32)
            native.idx_scatter(h, pos.astype(np.uint32), rid, b,
                               cursors, hs, vp, vr)
        del cursors
        if sp is not None:
            stats.end(sp)
        sp = stats.begin("index.sort") if stats.ON else None
        nk = native.idx_sort_count(hs, vp, vr, boff)
        keys = np.empty(nk, np.uint64)
        offsets = np.empty(nk + 1, np.uint32)
        bkt_off = np.empty(nbkt + 1, np.int64)
        native.idx_emit(hs, boff, b, keys, offsets, bkt_off)
        del hs, boff
        pos_out, rid_out = vp, vr
        run_cnt = offsets[1:] - offsets[:-1]             # u32
    else:
        # numpy fallback: same layout, all triples in memory
        hs_l, ps_l, rs_l = [], [], []
        for sid in range(len(codes)):
            h, pos, strand = sketch(_prep(sid), k, w)
            hs_l.append(h)
            ps_l.append(pos.astype(np.uint32))
            rs_l.append(((sid << 1) | strand.astype(np.uint32))
                        .astype(np.uint32))
        h = np.concatenate(hs_l) if hs_l else np.empty(0, np.uint64)
        pos = np.concatenate(ps_l) if ps_l else np.empty(0, np.uint32)
        rid = np.concatenate(rs_l) if rs_l else np.empty(0, np.uint32)
        del hs_l, ps_l, rs_l
        if sp is not None:
            stats.end(sp)
        sp = stats.begin("index.sort") if stats.ON else None
        bucket = (h & mask).astype(np.int64)
        order = np.argsort(bucket, kind="stable")
        h, pos, rid, bucket = (h[order], pos[order], rid[order],
                               bucket[order])
        del order
        boff = np.zeros(nbkt + 1, np.int64)
        np.cumsum(np.bincount(bucket, minlength=nbkt), out=boff[1:])
        ord_n = native.idx_bucket_sort(h, b) if native.available() \
            else None
        if ord_n is not None:
            h, pos, rid = h[ord_n], pos[ord_n], rid[ord_n]
        else:
            from ..ksort import ks_radix128
            for bi in range(nbkt):
                s0, s1 = int(boff[bi]), int(boff[bi + 1])
                if s1 - s0 > 1:
                    perm = s0 + ks_radix128(h[s0:s1] >> np.uint64(b))
                    h[s0:s1] = h[perm]
                    pos[s0:s1] = pos[perm]
                    rid[s0:s1] = rid[perm]
        # NOTE idx_bucket_sort re-derives the counting scatter, so it
        # must see the PRE-bucketed arrival order; with the stable
        # argsort already applied above the buckets are contiguous and
        # the scatter inside is an identity — both paths agree.
        newkey = np.ones(len(h), bool)
        if len(h):
            newkey[1:] = h[1:] != h[:-1]
        kidx = np.flatnonzero(newkey)
        keys = h[kidx]
        offsets = np.concatenate(
            [kidx, [len(h)]]).astype(np.uint32)
        bkt_off = np.searchsorted(bucket[kidx] if len(h) else bucket,
                                  np.arange(nbkt + 1)).astype(np.int64)
        pos_out, rid_out = pos, rid
        run_cnt = offsets[1:] - offsets[:-1]

    # occurrence thresholds (minialign.c:2984-2988): the (1-frq)-
    # quantile of per-key multiplicities + 1 via partial selection
    # (the reference quickselects, ks_ksmall)
    occ = np.empty(len(params.frq), np.uint32)
    if len(run_cnt):
        scr = run_cnt.copy()
        for i, f in enumerate(params.frq):
            if f <= 0.0:
                occ[i] = np.uint32(0xFFFFFFFF)
            else:
                ix = min(int((1.0 - f) * len(scr)), len(scr) - 1)
                scr.partition(ix)
                occ[i] = scr[ix] + 1
        del scr
    else:
        occ[:] = 1

    mi = MMIndex(
        k=k, w=w, occ=occ, frq=tuple(params.frq),
        names=list(names),
        lens=np.asarray([len(c) for c in codes], np.int64),
        circular=circ,
        codes=[np.asarray(c, np.int8) for c in codes],
        keys=keys, offsets=offsets, vals_pos=pos_out,
        vals_rid=rid_out, b=b, bkt_off=bkt_off,
    )
    if sp is not None:
        stats.end(sp)
    return mi
