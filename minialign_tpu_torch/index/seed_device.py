"""Round-0 seed collection of a whole read batch on a device.

seed_pass runs, for every read of a batch at once, what chain.collect_seeds
runs for one read (mm_collect_seed, minialign.c:3454-3493): the
(w,k)-minimizer sketch, the two-stage lookup in the bucket-major index
(the bucket head from bkt_off, then lower_bound in the bucket's keys), the
classification (drop a missing key, cnt == 0 and cnt > max_occ; a rescue
row (qs, cnt, start) for occ0 < cnt <= max_occ) and mm_expand of the rest
into (upos, vpos, rid) seeds. The reads are the forward strands of a
FillEngine's query store. For a CUDA store the kernel (csrc/seed.cu, three
launches) runs, and there is no other route there; for a CPU store
seed_pass_plain, the same function in PyTorch array ops, which runs on any
device (chip_smoke.py holds the kernel to it on the card).

Only k <= 16 is taken, where collect_seeds_c's hash (crc32c(kx) ^ km) &
mask is the canonical k-mer km (the CRC term is 0 for kx < 2^32,
csrc/sketch.cu:hash_segment), and w <= 64, where collect_seeds_c sketches
at all; `eligible` says whether an index qualifies. The index's tables go
to the device as they are: zero-copy views of its numpy arrays, copied
once to a card, not sorted, cast or rebuilt (`tables`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda_sketch

MAX_K = 16
MAX_W = 64
TILE = 1024              # positions a block of csrc/seed.cu's seed_count
OFS = 0x40000000         # chain.OFS: the rotated coordinates' offset
BIG = 1 << 62            # above every v (h << 8 | lo < 2^40)


@dataclasses.dataclass
class SeedTables:
    """The index's bucket-major tables on one device, as views of its own
    arrays: keys (K,) int64 bits of uint64 (each < 2^32 for k <= 16),
    bkt_off (2^b + 1,) int64, offsets (K + 1,), vals_pos and vals_rid (V,)
    int32 bits of uint32."""
    keys: torch.Tensor
    bkt_off: torch.Tensor
    offsets: torch.Tensor
    vals_pos: torch.Tensor
    vals_rid: torch.Tensor
    b: int


def eligible(mi) -> bool:
    """Whether seed_pass can stand for chain.collect_seeds on index mi:
    k <= 16 and w <= 64, and the bucket-major layout with uint32 runs that
    native.collect_seeds reads, each table contiguous."""
    bkt = getattr(mi, "bkt_off", None)
    if not (1 <= mi.k <= MAX_K and 1 <= mi.w <= MAX_W) or bkt is None:
        return False
    arrs = (mi.keys, bkt, mi.offsets, mi.vals_pos, mi.vals_rid)
    want = (np.uint64, np.int64, np.uint32, np.uint32, np.uint32)
    return (len(bkt) == (1 << mi.b) + 1 and len(mi.offsets) == len(mi.keys) + 1
            and all(a.dtype == t and a.flags.c_contiguous
                    for a, t in zip(arrs, want)))


def tables(mi, device: torch.device) -> SeedTables:
    """mi's tables on `device`: each a view of its numpy array (no host
    copy), copied once to a card."""
    def put(a, dt):
        return torch.from_numpy(a.view(dt)).to(device)
    return SeedTables(keys=put(mi.keys, np.int64),
                      bkt_off=put(mi.bkt_off, np.int64),
                      offsets=put(mi.offsets, np.int32),
                      vals_pos=put(mi.vals_pos, np.int32),
                      vals_rid=put(mi.vals_rid, np.int32), b=int(mi.b))


def pack_desc(read_off: np.ndarray, read_len: np.ndarray, k: int):
    """The kernel's int64 descriptor block: each read's first code in the
    store, its length, its first tile of TILE k-mer positions (then the
    tile count), and each tile's read. Returns (block, tiles)."""
    nt = -(-np.maximum(np.asarray(read_len, np.int64) - k + 1, 0) // TILE)
    tile0 = np.concatenate([[0], np.cumsum(nt)]).astype(np.int64)
    read = np.repeat(np.arange(len(nt), dtype=np.int64), nt)
    blk = np.concatenate([np.asarray(read_off, np.int64),
                          np.asarray(read_len, np.int64), tile0, read])
    return blk, int(tile0[-1])


def lanes(w: int) -> tuple[int, int]:
    """(S, G): the threads of seed_count that take one w-block of a tile's
    (TILE + 2w - 1) // w in its sliding minimum, and the slots of each
    one's segment, by the device sketch's rules (cuda_sketch.segments and
    segment_len: seed_count keeps its slots in the same [slot][w-block]
    arrays)."""
    S = cuda_sketch.segments((TILE + 2 * w - 1) // w)
    return S, cuda_sketch.segment_len(w, S)


def pass_bytes(n_pos: int, n_min: int, n_seed: int, n_resc: int) -> int:
    """The least bytes a pass moves: a code a position; an emitted
    minimizer's bucket head (two int64), key (8 B) and run (two uint32);
    a seed's vals_pos and vals_rid read and upos, vpos and rid written; a
    rescue row's 12 B written."""
    return n_pos + 32 * n_min + 20 * n_seed + 12 * n_resc


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits of uint32 values, as int64."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as the C code's casts wrap them."""
    return ((t + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def seed_pass_plain(store: torch.Tensor, read_off, read_len,
                    tab: SeedTables, k: int, w: int, max_occ: int,
                    occ0: int):
    """seed_pass's plain version, in array ops on the store's device.
    Returns (per-read sums (R + 1, 2) int64 numpy: each read's first seed
    and first rescue row, [R] the totals; the packed int32 output: upos,
    vpos, rid of every seed, then (qs, cnt, start) of every rescue row)."""
    dev = store.device
    off = torch.as_tensor(np.asarray(read_off, np.int64), device=dev)
    ln = torch.as_tensor(np.asarray(read_len, np.int64), device=dev)
    R = len(off)
    i64 = dict(dtype=torch.int64, device=dev)
    n = (ln - k + 1).clamp(min=0)
    rd = torch.repeat_interleave(torch.arange(R, **i64), n)
    g = torch.arange(int(n.sum()), **i64)
    p = g - (torch.cumsum(n, 0) - n)[rd]            # position in its read
    at = off[rd] + p
    k0 = torch.zeros_like(g)
    k1 = torch.zeros_like(g)
    for j in range(k):
        c = store[at + j].to(torch.int64) & 3
        k0 = k0 << 2 | c
        k1 |= (3 ^ c) << (2 * j)
    del at
    strand = (k1 <= k0).to(torch.int64)
    v = torch.where(strand == 1, k1, k0) << 8 | p % w | strand << 7
    del k0, k1, strand
    # the window's least v; a window's v differ in p % w, so it is one
    # position's, and p - a follows from its p % w
    m = v.clone()
    for d in range(1, w):
        m = torch.minimum(m, torch.where(p >= d, v[(g - d).clamp(min=0)],
                                         BIG))
    del v
    a = p - (p % w - (m & 0x7F)) % w
    prev = torch.where(p > 0, m[(g - 1).clamp(min=0)], -1)
    e = ((p == 0) | (m != prev) | (a == p)).nonzero().squeeze(1)
    del prev
    me, pos, re_ = m[e], a[e], rd[e]
    del m, a, p, rd, g
    h = me >> 8
    fr = (me >> 7) & 1
    # lower_bound of h in its bucket, every minimizer at once
    bkt = h & ((1 << tab.b) - 1)
    lo, hi = tab.bkt_off[bkt], tab.bkt_off[bkt + 1]
    nk = tab.keys.numel()
    while nk:
        act = lo < hi
        if not bool(act.any()):
            break
        mid = (lo + hi) >> 1
        less = tab.keys[mid.clamp(max=nk - 1)] < h
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)
    li = lo.clamp(max=max(nk - 1, 0))
    if nk:
        found = (lo < nk) & (tab.keys[li] == h)
        start = _u32(tab.offsets[li])
        cnt = _u32(tab.offsets[li + 1]) - start
    else:
        found = torch.zeros_like(h, dtype=torch.bool)
        start = cnt = torch.zeros_like(h)
    keep = found & (cnt > 0) & (cnt <= max_occ)
    qs = (pos + k * fr) ^ (-fr)
    resc = keep & (cnt > occ0)
    ce = torch.where(keep & ~resc, cnt, 0)
    # mm_expand: each kept run's hits in index order
    src = torch.repeat_interleave(torch.arange(len(ce), **i64), ce)
    u = start[src] + (torch.arange(len(src), **i64)
                      - (torch.cumsum(ce, 0) - ce)[src])
    rv = _u32(tab.vals_rid[u])
    rev = rv & 1
    x = _u32(tab.vals_pos[u]) + k * rev
    q = qs[src]
    y = torch.where(rev == 1, ~q, q)
    ri = resc.nonzero().squeeze(1)
    rows = torch.stack([qs[ri], cnt[ri], start[ri]], 1)
    out = torch.cat([_i32(2 * x - y + OFS), _i32(2 * y - x + OFS),
                     _i32(rv >> 1), _i32(rows).reshape(-1)])
    sums = torch.zeros((R + 1, 2), **i64)
    sums[:, 0].index_add_(0, re_ + 1, ce)
    sums[:, 1].index_add_(0, re_[ri] + 1, torch.ones_like(ri))
    return torch.cumsum(sums, 0).cpu().numpy(), out


def seed_pass_cuda(store: torch.Tensor, read_off, read_len,
                   tab: SeedTables, k: int, w: int, max_occ: int,
                   occ0: int):
    """seed_pass on the card: csrc/seed.cu's seed_count and seed_scan, the
    per-read sums read back (they size the output), then seed_write.
    Returns what seed_pass_plain returns, the output on the card."""
    from .. import _build
    if store.device.type != "cuda" or store.dtype != torch.int8 or \
            not store.is_contiguous():
        raise ValueError("seed_pass_cuda: the store must be a contiguous "
                         "int8 CUDA tensor")
    if not (1 <= k <= MAX_K and 1 <= w <= MAX_W):
        raise ValueError(f"seed_pass_cuda: needs 1 <= k <= {MAX_K} and "
                         f"1 <= w <= {MAX_W} (k={k}, w={w})")
    dev = store.device
    t = (tab.keys, tab.bkt_off, tab.offsets, tab.vals_pos, tab.vals_rid)
    if any(x.device != dev or not x.is_contiguous() for x in t):
        raise ValueError("seed_pass_cuda: the index tables must be "
                         "contiguous and on the store's device")
    R = len(read_off)
    if R and (int(np.min(read_off)) < 0 or int(np.max(
            np.asarray(read_off) + np.asarray(read_len))) > store.numel()):
        raise ValueError("seed_pass_cuda: a read reaches outside the store")
    blk, ntiles = pack_desc(read_off, read_len, k)
    if ntiles >= 1 << 31:
        raise ValueError(f"seed_pass_cuda: {ntiles} tiles")
    from ..dp.cuda_gather import upload
    lib = _build.library()
    i64 = dict(dtype=torch.int64, device=dev)
    desc = upload(blk, dev)
    rec = torch.empty(ntiles * TILE * 4, dtype=torch.int32, device=dev)
    tile_cnt = torch.empty(ntiles, **i64)
    tile_pre = torch.empty(2 * ntiles, **i64)
    read_pre = torch.empty(2 * (R + 1), **i64)
    stream = _build.stream_of(store)
    S, G = lanes(w)
    with torch.cuda.device(dev):
        rc = lib.seed_count_launch(
            store.data_ptr(), desc.data_ptr(), R, ntiles, k, w, S, G,
            tab.keys.data_ptr(), tab.keys.numel(), tab.bkt_off.data_ptr(),
            tab.b, tab.offsets.data_ptr(), max_occ, occ0, rec.data_ptr(),
            tile_cnt.data_ptr(), tile_pre.data_ptr(), read_pre.data_ptr(),
            stream)
    _build.count("seed")                 # seed_scan
    if ntiles:
        _build.count("seed")             # seed_count
    _build.check(lib, rc, "seed_count kernel")
    sums = read_pre.cpu().numpy().reshape(R + 1, 2)
    nseed, nresc = int(sums[R, 0]), int(sums[R, 1])
    out = torch.empty(3 * (nseed + nresc), dtype=torch.int32, device=dev)
    if nseed + nresc:
        with torch.cuda.device(dev):
            rc = lib.seed_write_launch(
                ntiles, k, occ0, tab.vals_pos.data_ptr(),
                tab.vals_rid.data_ptr(), rec.data_ptr(), tile_cnt.data_ptr(),
                tile_pre.data_ptr(), nseed, out.data_ptr(), stream)
        _build.count("seed")
        _build.check(lib, rc, "seed_write kernel")
    return sums, out


def seed_pass(store: torch.Tensor, read_off, read_len, tab: SeedTables,
              k: int, w: int, max_occ: int, occ0: int):
    """Round-0 seeds of the reads store[read_off[r]:][:read_len[r]] (2-bit
    codes, taken & 3) against tab: (per-read sums (R + 1, 2) int64 numpy,
    the packed int32 output on the store's device); `split` cuts them. The
    kernel for a CUDA store (it launches or raises), the plain version for
    a CPU store."""
    if store.device.type == "cuda":
        return seed_pass_cuda(store, read_off, read_len, tab, k, w,
                              max_occ, occ0)
    if store.device.type == "cpu":
        return seed_pass_plain(store, read_off, read_len, tab, k, w,
                               max_occ, occ0)
    raise ValueError(f"no seed pass for device {store.device}")


def split(sums: np.ndarray, out: np.ndarray) -> list:
    """Each read's (upos, vpos, rid, resc) from seed_pass's sums and its
    packed output on the host, as native.collect_seeds returns them: three
    int32 arrays (views of out) and the rescue rows as (m, 3) int64."""
    S, M = int(sums[-1, 0]), int(sums[-1, 1])
    up, vp, rd = out[:S], out[S:2 * S], out[2 * S:3 * S]
    rows = out[3 * S:3 * (S + M)].reshape(M, 3)
    resc = np.empty((M, 3), np.int64)
    resc[:, :2] = rows[:, :2]
    resc[:, 2] = rows[:, 2].view(np.uint32)
    return [(up[a:b], vp[a:b], rd[a:b], resc[c:d])
            for (a, c), (b, d) in zip(sums[:-1], sums[1:])]
