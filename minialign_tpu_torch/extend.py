"""Batched extension: the per-read extension generators and the device
FillEngine.

Carries the host half of minialign_tpu/extend.py unchanged (_key, Seg,
Aln, split_segments, Bin, rle_paths_py, _SearchState, _load_next,
extend_read and helpers); only the imports differ. See that module's
docstring for the scheduling design and the reference citations.

FillEngine is new: it runs the same requests through the port's
kernels (the fill reading the sequence stores -> traceback walk, dp/),
on a named device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .chain import (_u, _v, chain_seeds, collect_seeds, coords_to_xy,
                    seed_round)
from .device import resolve_device
from .dp import band
from .dp.band import fill_store
from .dp.cuda_gather import pack_desc, upload
from .dp.dtrace import SUMMARY_ROWS, dtrace
from .dp.duo import CAPU_ADD, pack_geom
from .dp.traceback import TraceResult, _identity, traceback_one
from .index.build import MMIndex
from .params import MapParams, ScoreParams

MM_CREM = 50000
MM_SREM = 8
WIDTHS = (64, 32, 16)      # indexed by st.narrow


def _key(x: int, y: int) -> int:
    """_key position-hash fold (minialign.c:3362)."""
    x &= (1 << 64) - 1
    y &= (1 << 64) - 1
    swap = ((y & 0xFFFFFFFF) << 32) | (y >> 32)
    return (x ^ (x >> 29) ^ y ^ swap) & ((1 << 64) - 1)


def _poskey(apos: int, bpos: int, rid: int, qid: int) -> int:
    return _key((apos & 0xFFFFFFFF) | ((bpos & 0xFFFFFFFF) << 32),
                (rid & 0xFFFFFFFF) | ((qid & 0xFFFFFFFF) << 32))


@dataclasses.dataclass
class Seg:
    """One gaba_path_section_t-equivalent: a piece of an alignment
    lying within a single pass over the reference (alignments on
    circular references split at the origin; gaba.c:2862
    trace_push_segment). Coordinates are mod-rlen on the ref side."""
    as0: int
    ae: int
    bs0: int
    be: int
    path: str
    po: int = 0            # start offset within the full forward path
                           # (display order); maps to the up-space bit
                           # position for the printers' reverse parse


@dataclasses.dataclass
class Aln:
    rid: int
    rev: int
    as0: int               # head-segment ref start (forward, mod coords)
    ae: int                # tail-segment ref end (mod coords)
    bs0: int               # query start (strand space)
    be: int                # query end (strand space)
    score: int
    path: str              # forward-space ops: D=query base, R=ref base
    identity: float
    dcnt: int
    agcnt: int
    bgcnt: int
    segs: list = None      # [Seg] head-to-tail; None -> single segment
    upath: str = ""        # up-space bit path (gaba's aln->path order);
                           # the printers reverse-parse this
                           # (gaba_dump_cigar_reverse, minialign.c:5173)

    def __post_init__(self):
        if self.segs is None:
            self.segs = [Seg(self.as0, self.ae, self.bs0, self.be,
                             self.path, po=0)]

    @property
    def plen(self) -> int:
        return len(self.path)

    @property
    def slen(self) -> int:
        return len(self.segs)


def split_segments(as0_u: int, bs0: int, path: str, rlen: int,
                   ops: list | None = None) -> list:
    """Split a (possibly origin-wrapping) alignment into per-pass
    segments. as0_u is the unwrapped ref start (negative when the
    alignment began before the origin of the final pass); the split
    points are the multiples of rlen crossed by the ref walk."""
    # walk the WALKER's pop tokens (ops: 'X' diagonal pair / 'R' /
    # 'D'), not raw path chars: gaba pushes the segment boundary when a
    # pop's section test fires, and only h-gap and diagonal pops test
    # the a-side index (_trace_tail_h/d_test_index, gaba.c:2935-2937).
    # A v-gap pop checks bgidx alone, so insertions that follow the
    # origin-crossing DIAGONAL stay in the current segment, while a
    # lone crossing R (gap pop, returning to d_head) splits at once.
    if ops is None:
        ops = []                   # derive pair tokens from the chars
        i = 0
        while i < len(path):
            if path[i] == "D" and i + 1 < len(path) \
                    and path[i + 1] == "R":
                ops.append("X")
                i += 2
            else:
                ops.append(path[i])
                i += 1
    segs = []
    seg_a0, seg_b0, start = as0_u, bs0, 0
    apos, bpos = as0_u, bs0
    pos = 0                        # char position in path
    k, n = 0, len(ops)
    while k < n:
        t = ops[k]
        if t == "X" or t[0] == "R":
            w = len(t) if t[0] == "R" else 1
            crossed = False
            for _ in range(w):     # boundary drains are multi-R tokens
                apos += 1
                if apos % rlen == 0:
                    crossed = True
            if t == "X":
                bpos += 1
            pos += 2 if t == "X" else len(t)
            k += 1
            if crossed:
                if t == "X":
                    # absorb following v pops into this segment
                    while k < n and ops[k][0] == "D":
                        bpos += len(ops[k])
                        pos += len(ops[k])
                        k += 1
                if k < n:
                    segs.append(Seg(seg_a0 % rlen,
                                    ((apos - 1) % rlen) + 1,
                                    seg_b0, bpos, path[start:pos],
                                    po=start))
                    seg_a0, seg_b0, start = apos, bpos, pos
        else:
            bpos += len(t)
            pos += len(t)
            k += 1
    segs.append(Seg(seg_a0 % rlen, ((apos - 1) % rlen) + 1, seg_b0, bpos,
                    path[start:], po=start))
    return segs


@dataclasses.dataclass
class Bin:
    """mm_bin_t. lb/ub init note: the source (minialign.c:3855) writes
    `.lb = UINT32_MAX` through a compound literal pushed as void**, a
    strict-aliasing violation that gcc -O3 (the release build, and the
    build behind every published benchmark and our golden files) elides
    — the released binary runs with lb = 0, so ovl degenerates to
    `be - min(ub, be)` and lb stays 0 forever. We match the release
    binary (PARITY.md item 5)."""
    n_aln: int = 0
    plen: int = 0
    lb: int = 0
    ub: int = 0
    slot_idx: list = dataclasses.field(default_factory=list)
    mapq: int = 0


def revcomp_codes(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c)
    out = (3 - c[::-1]).astype(np.int8)
    out[np.asarray(c[::-1]) > 3] = band.NCODE
    return out


def ref_revcomp(mi, rid: int) -> np.ndarray:
    """Cached reverse complement of reference sequence `rid` — the
    root loader needs it per chain, and recomputing a multi-Mb
    revcomp per chain dominated host time (measured 5.3 s of a 21 s
    E2E run). The cache lives on the index object (works through the
    ShardedIndex facade too)."""
    cache = getattr(mi, "_codes_rev", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(mi, "_codes_rev", cache)
        except (AttributeError, TypeError):
            return revcomp_codes(np.asarray(mi.codes[rid], np.int8))
    if rid not in cache:
        cache[rid] = revcomp_codes(np.asarray(mi.codes[rid], np.int8))
    return cache[rid]



# byte LUTs for op-code -> path-string builds (op 3 = diagonal is
# two chars: "RD" backward / "DR" in rev-token order)
_LUT_FWD1 = np.frombuffer(b"\0DRR", np.uint8)
_LUT_REV1 = np.frombuffer(b"\0DRD", np.uint8)
_LUT_TOK = np.frombuffer(b"\0DRX", np.uint8)


def rle_paths_py(ent: np.ndarray):
    """Pure-numpy fallback for native.rle_paths: expand bit-packed
    (op | len << 2) RLE entries into (path, path_rev, ops_rev)
    strings. Parity with the native implementation is enforced by
    tests/test_native.py::test_rle_paths_parity. Byte-LUT builds: a
    join of 10k 1-2 char strings per alignment measured 7.5 s/500
    reads."""
    ent = np.asarray(ent)
    col = np.repeat(ent & 3, ent >> 2)
    widths = np.where(col == 3, 2, 1)
    starts = np.cumsum(widths) - widths
    total = int(starts[-1] + widths[-1]) if len(col) else 0
    bf = np.empty(total, np.uint8)
    bf[starts] = _LUT_FWD1[col]
    bf[starts[col == 3] + 1] = ord("D")
    path = bytes(bf[::-1]).decode()
    bf[starts] = _LUT_REV1[col]
    bf[starts[col == 3] + 1] = ord("R")
    path_rev = bytes(bf).decode()
    ops_rev = bytes(_LUT_TOK[col]).decode()
    return path, path_rev, ops_rev


# ---------------------------------------------------------------------------
# device batch engine
# ---------------------------------------------------------------------------

def _row_len(elen) -> int:
    """A side's row length: its longest problem, in 128-byte multiples."""
    return max(128, -(-int(elen.max()) // 128) * 128)


def _general(side) -> bool:
    """Whether a side's rows need the fill's general window loads: a row
    that wraps (a circular reference) or starts before its segment."""
    return bool((side["wrap"] > 0).any() or (side["start"] < 0).any())


def _host(t: torch.Tensor) -> np.ndarray:
    """A device result on the host: the engine's only reads (a harvest's
    summary and run-length entries), each one waiting for the stream."""
    return t.cpu().numpy()


def host_walk(p: ScoreParams, summ: np.ndarray, W: int, bufs) -> list:
    """Traced results walked on the host (MINIALIGN_HOST_TRACE on the
    CPU, as minialign_tpu/extend.py:958-986): from the (3, B) score, i and
    j, only the trace blocks that the walk can reach are taken (it starts
    at the max and never passes it), and each problem is walked by
    dp/traceback.traceback_one (the host library's trace_one when it is
    loaded). The trace buffers must lie on the CPU: the card's are walked
    there by dtrace."""
    if bufs.dirs.device.type != "cpu":
        raise ValueError("host_walk walks trace buffers on the CPU; the "
                         "card's are walked by dtrace")
    ms, mi, mj = (x.astype(np.int64) for x in summ)
    nblk = int((mi + mj).max()) // band.BLK + 2
    nblk = min(-(-nblk // 32) * 32, bufs.dirs.shape[1])
    masks = _host(bufs.masks[:, :nblk]).view(np.uint32)
    dirs = _host(bufs.dirs[:, :nblk]).view(np.uint32)
    iheads = _host(bufs.iheads)
    return [(int(ms[s]), int(mi[s]), int(mj[s]), traceback_one(
        p, W, masks[s], dirs[s], iheads[s], int(ms[s]), int(mi[s]),
        int(mj[s]))) for s in range(len(ms))]


def _bucket(n: int) -> int:
    """Power-of-two length bucket, floor 512: requests are grouped by
    bucket so that a batch's rows and trace buffers stay near the size
    its problems need."""
    b = 512
    while b < n:
        b *= 2
    return b


class FillEngine:
    """Runs extension requests on one device.

    The reference and the current read batch live on the device as flat
    int8 stores, forward strand then reverse complement per sequence.
    Each request's two windows are read from them by the fill itself
    (dp/band.fill_store: the fill kernel in store mode, one launch a
    batch, as the JAX package's _fused_fn is one dispatch) and, for
    traced requests, walked backward (dp/dtrace), all on the device;
    only scores, max positions, run-length entries and counters come
    back to the host.

    pipeline.align_batch takes the device-store path when `use_pallas`
    is set (the JAX engine's name for it), so it is always True here,
    and it sends the fused down+up "duo" request (supports_duo) unless
    MINIALIGN_DUO=0. A duo batch (minialign_tpu/extend.py:675-737
    _duo_fn) runs on one stream with no host wait between its fills:
    one upload (the down descriptor block and the geometry), the untraced
    down fill, whose epilogue computes the up windows from the down max
    (dp/duo), the traced W=64 up fill reading the up descriptor rows
    that epilogue wrote, and the walk: three launches, then one summary
    read-back that holds the down rows too. The JAX engine's _duo_slow
    (its two-step fallback for sides its TPU DMA gather refuses: wrap, a
    negative start, L % 1024, L > 262,144) is not carried: the port's
    store-mode fill takes all of them, and duo requests come only for
    non-circular references.
    """

    use_pallas = True
    supports_duo = True

    def __init__(self, score: ScoreParams, batch: int | None = None,
                 device: str | torch.device = "cuda"):
        score.check()
        self.p = score
        self.device = resolve_device(device)
        self.batch = batch or 512     # problems per launch
        self._ref_src = None
        # launch-shape statistics (MINIALIGN_STATS=1 prints at exit), as
        # the JAX engine keeps them (minialign_tpu/extend.py:307-325):
        # (kind, n_real, B) per traced launch batch ("trace": the walk
        # on the device; "duo"), n_real the problem count rounded up to
        # 16 as the JAX engine counts it, B the launch's own problem
        # count (the port pads no dispatch). None when the flag is unset
        # so that long-lived processes don't grow the list.
        self.stats = None
        if os.environ.get("MINIALIGN_STATS"):
            import atexit

            self.stats = []

            def _dump(st=self.stats):
                import collections
                import sys
                c = collections.Counter(st)
                for k, n in sorted(c.items()):
                    print(f"[stats] {k[0]} nreal={k[1]} B={k[2]} "
                          f"x{n}", file=sys.stderr)
            atexit.register(_dump)

    def _store(self, parts) -> torch.Tensor:
        """The flat store on the device."""
        flat = np.concatenate(parts) if parts else np.zeros(1, np.int8)
        return torch.from_numpy(np.asarray(flat, np.int8)).to(self.device)

    def set_index(self, mi) -> None:
        """Upload the reference store (kept while `mi.codes` is the same
        object: align_batch calls this once per read batch)."""
        if self._ref_src is mi.codes:
            return
        parts, fw, rv, lens = [], [], [], []
        off = 0
        for rid, c in enumerate(mi.codes):
            c = np.asarray(c, np.int8)
            fw.append(off)
            rv.append(off + len(c))
            parts += [c, ref_revcomp(mi, rid)]
            off += 2 * len(c)
            lens.append(len(c))
        self._ref_store = self._store(parts)
        self._ref_fw, self._ref_rv, self._ref_len = fw, rv, lens
        self._ref_src = mi.codes

    def set_queries(self, reads) -> None:
        parts, bases, lens = [], [], []
        off = 0
        for c in reads:
            c = np.asarray(c, np.int8)
            bases.append((off, off + len(c)))
            parts += [c, revcomp_codes(c)]
            off += 2 * len(c)
            lens.append(len(c))
        self._q_store = self._store(parts)
        self._q_bases, self._q_len = bases, lens

    def _side_meta(self, specs):
        """Per-problem (base, start, cap, seglen, wrap, elen) rows of one
        side and its store. Spec forms (minialign_tpu/extend.py
        _side_meta):
          ("ref", rid, rev, start, cap, wrap)   wrap>0 = circular mod
          ("q", qidx, which, start)             which 1 = revcomp
        """
        B = len(specs)
        base = np.zeros(B, np.int64)
        start, cap, seglen, wrap, elen = (np.zeros(B, np.int32)
                                          for _ in range(5))
        store = None
        for s, spec in enumerate(specs):
            elen[s] = self._spec_len(spec)
            if spec[0] == "ref":
                _, rid, rev, st0, cp, wr = spec
                store = self._ref_store
                base[s] = self._ref_rv[rid] if rev else self._ref_fw[rid]
                start[s], seglen[s], wrap[s], cap[s] = (
                    st0, self._ref_len[rid], wr, cp)
            else:
                _, qidx, which, st0 = spec
                store = self._q_store
                b0, b1 = self._q_bases[qidx]
                base[s] = b1 if which else b0
                start[s], seglen[s], cap[s] = st0, self._q_len[qidx], elen[s]
        return dict(base=base, start=start, cap=cap, seglen=seglen,
                    wrap=wrap, elen=elen, store=store)

    def _spec_len(self, spec) -> int:
        """Bases one side of a request holds: a raw code array's length,
        or what a store slice spec reaches before its segment ends."""
        if isinstance(spec, np.ndarray):
            return len(spec)
        if spec[0] == "ref":
            _, rid, _, st0, cp, wr = spec
            return cp if wr else max(0, min(cp, self._ref_len[rid] - st0))
        _, qidx, _, st0 = spec
        return max(0, self._q_len[qidx] - st0)

    def _raw_meta(self, a_specs, b_specs):
        """Side rows for raw code arrays (the host-built path,
        MINIALIGN_DEVICE_SEQS=0): every array of the batch in one store,
        uploaded once, each row a whole segment."""
        seqs = [np.asarray(x, np.int8) for x in (*a_specs, *b_specs)]
        lens = np.asarray([len(x) for x in seqs], np.int32)
        base = np.concatenate([[0], np.cumsum(lens[:-1], dtype=np.int64)])
        flat = np.concatenate(seqs) if seqs else np.zeros(1, np.int8)
        store = upload(flat, self.device)
        zero = np.zeros(len(seqs), np.int32)
        m = dict(base=base, start=zero, cap=lens, seglen=lens, wrap=zero,
                 elen=lens)
        B = len(a_specs)
        return ({k: v[:B] for k, v in m.items()} | {"store": store},
                {k: v[B:] for k, v in m.items()} | {"store": store})

    def _batch(self, a_specs, b_specs):
        """Both sides of one fill batch on the device, as fill_store takes
        them: ((store_a, store_b, block, B, La, Lb), n_blocks, general).
        Every row's fields, the fill's lengths included, go up in one
        packed block (one non-blocking copy from pinned memory on a
        card), from which the fill reads its windows."""
        if isinstance(a_specs[0], np.ndarray):
            ma, mb = self._raw_meta(a_specs, b_specs)
        else:
            ma, mb = self._side_meta(a_specs), self._side_meta(b_specs)
        blk = upload(pack_desc([ma, mb]), self.device)
        return ((ma["store"], mb["store"], blk, len(a_specs),
                 _row_len(ma["elen"]), _row_len(mb["elen"])),
                band.max_blocks_for(ma["elen"], mb["elen"]),
                _general(ma) or _general(mb))

    def run(self, reqs: list) -> list:
        """reqs: list of (kind, a, b, W) with kind 'down' or 'up', a/b
        store slice specs or raw code arrays, or ('duo', a, b, W, meta)
        with meta = (rid, rev, qidx, rlen, qlen, cp0, cp1) (extend_read).
        Returns, in request order, (score, mi, mj, trace|None) per down
        or up request ('up' requests are traced: walked by dtrace, or,
        when MINIALIGN_HOST_TRACE is set and the engine is on the CPU,
        by host_walk) and (score, mi, mj, up score, up mi, up mj, trace)
        per duo request (always dtrace). On the card the variable is
        ignored: its walk stays there."""
        out = [None] * len(reqs)
        groups = {}
        for i, req in enumerate(reqs):
            kind, a, b, W = req[0], req[1], req[2], req[3]
            if kind not in ("down", "up", "duo"):
                raise ValueError(f"FillEngine serves 'down', 'up' and "
                                 f"'duo' requests, not {kind!r}")
            key = (kind, W, _bucket(self._spec_len(a) + band.TAIL_N + 128),
                   _bucket(self._spec_len(b) + band.TAIL_N + 128))
            if kind == "duo":
                # the JAX engine's duo groups (minialign_tpu/extend.py:
                # 863-869): the up sides' buckets from their bounds
                rlen, qlen = req[4][3], req[4][4]
                key += (_bucket(min(2 * qlen + CAPU_ADD, rlen)
                                + band.TAIL_N + 128),
                        _bucket(qlen + band.TAIL_N + 128))
            groups.setdefault(key, []).append(i)
        # launch every batch before the first harvest: the device works
        # through the queue while the host copies results back
        pending = []
        for (kind, W, *_), idxs in groups.items():
            for k in range(0, len(idxs), self.batch):
                sub = idxs[k:k + self.batch]
                if kind == "duo":
                    pending.append((sub, kind) + self._duo_batch(
                        [reqs[i] for i in sub], W))
                    self._stat("duo", len(sub))
                    continue
                side, nb, general = self._batch(
                    [reqs[i][1] for i in sub], [reqs[i][2] for i in sub])
                if kind == "up":
                    res, bufs = fill_store(self.p, W, nb, True, *side,
                                           general=general)
                    if os.environ.get("MINIALIGN_HOST_TRACE") and \
                            self.device.type == "cpu":
                        # the host walk (minialign_tpu/extend.py:958-986)
                        pending.append((sub, "host", (W, bufs), torch.stack(
                            [res.max_score, res.max_i, res.max_j])))
                        continue
                    pending.append((sub, kind) + dtrace(
                        self.p, W, bufs.masks, bufs.dirs, bufs.iheads,
                        res.max_score, res.max_i, res.max_j))
                    self._stat("trace", len(sub))
                else:
                    res = fill_store(self.p, W, nb, False, *side,
                                     general=general)
                    pending.append((sub, kind, None, torch.stack(
                        [res.max_score, res.max_i, res.max_j])))
        # held: the walk's run-length entries on the device, or the host
        # walk's (W, trace buffers)
        for sub, kind, held, summ_d in pending:
            summ = _host(summ_d)
            if kind == "down":
                for s, i in enumerate(sub):
                    out[i] = (int(summ[0, s]), int(summ[1, s]),
                              int(summ[2, s]), None)
                continue
            ups = host_walk(self.p, summ, *held) if kind == "host" else \
                self._harvest(summ, held)
            for s, i in enumerate(sub):
                out[i] = ups[s] if kind != "duo" else (
                    int(summ[-3, s]), int(summ[-2, s]), int(summ[-1, s]),
                    *ups[s])
        return out

    def _stat(self, kind: str, B: int) -> None:
        if self.stats is not None:
            self.stats.append((kind, -(-B // 16) * 16, B))

    def _duo_batch(self, reqs, W):
        """Launches one duo batch; returns (rle, summary) on the device,
        the summary (17, B): the walk's SUMMARY_ROWS, then the down score,
        i and j. Nothing is read back: the up sides are sized on the host
        from their bounds (tp0 <= rlen, tp1 <= qlen), and their rows and
        block budget from those bounds give the same results as from the
        exact lengths (band.max_blocks_for)."""
        B = len(reqs)
        ma = self._side_meta([r[1] for r in reqs])
        mb = self._side_meta([r[2] for r in reqs])
        rvbase, qub, rlen, qlen, cp0, cp1 = (np.zeros(B, np.int64)
                                             for _ in range(6))
        for s, (_, _, _, _, meta) in enumerate(reqs):
            rid, rev, qidx, rlen[s], qlen[s], cp0[s], cp1[s] = meta
            rvbase[s] = self._ref_rv[rid]
            qub[s] = self._q_bases[qidx][0 if rev else 1]
        desc = pack_desc([ma, mb])
        blk = upload(np.concatenate(
            [desc, pack_geom(rvbase, qub, rlen, qlen, cp0, cp1)]),
            self.device)
        nsr = len(SUMMARY_ROWS)
        summ = torch.empty((nsr + 3, B), dtype=torch.int32,
                           device=self.device)
        # the up window from the down max, in the down fill's epilogue
        _, up = fill_store(self.p, W,
                           band.max_blocks_for(ma["elen"], mb["elen"]),
                           False, ma["store"], mb["store"], blk[:len(desc)],
                           B, _row_len(ma["elen"]), _row_len(mb["elen"]),
                           duo=(blk[len(desc):], summ[nsr:]),
                           general=_general(ma) or _general(mb))
        # the up fill reads the up rows that epilogue wrote (stream order):
        # none wraps, each starts at rlen - tp0 or qlen - tp1 >= 0
        la = np.minimum(2 * qlen + CAPU_ADD, rlen)
        res, bufs = fill_store(self.p, 64, band.max_blocks_for(la, qlen),
                               True, self._ref_store, self._q_store, up, B,
                               _row_len(la), _row_len(qlen), general=False)
        rle, _ = dtrace(self.p, 64, bufs.masks, bufs.dirs, bufs.iheads,
                        res.max_score, res.max_i, res.max_j, out=summ[:nsr])
        return rle, summ

    def _harvest(self, summ, rle_d) -> list:
        """Traced results from a summary on the host (SUMMARY_ROWS first)
        and the walk's run-length entries on the device: (score, ai, bj,
        trace) a problem, each problem's entries decoded into paths
        (native.rle_paths, numpy fallback) and its counters priced
        (minialign_tpu/extend.py _trace_device_harvest)."""
        from . import native as _nat
        p = self.p
        row = dict(zip(SUMMARY_ROWS, summ))
        ms, mi, mj = row["score"], row["ai"], row["bj"]
        n_ent, bad = row["n_ent"], row["bad"]
        n = summ.shape[1]
        tmax = int(n_ent.max()) if n else 0
        rle = _host(rle_d[:, :tmax]).astype(np.int32)
        out = []
        for s in range(n):
            score = int(ms[s])
            ai, bj = int(mi[s]), int(mj[s])
            if score <= 0 or (ai == 0 and bj == 0):
                tr = TraceResult(score=max(score, 0), alen=0, blen=0,
                                 path="", path_rev="", dcnt=0, agcnt=0,
                                 bgcnt=0, identity=0.0, gap_penalty=0)
            elif bad[s]:
                tr = None
            else:
                ent = rle[s, :n_ent[s]]
                r3 = _nat.rle_paths(ent.astype(np.uint8))
                if r3 is None:
                    r3 = rle_paths_py(ent)
                path, path_rev, ops_rev = r3
                dcnt = int(row["dcnt"][s])
                gap_penalty = (int(row["n_open"][s]) * p.gi
                               + int(row["n_ext"][s]) * p.ge
                               + int(row["gf_pen"][s]))
                tr = TraceResult(
                    score=score, alen=ai, blen=bj, path=path,
                    path_rev=path_rev, dcnt=dcnt,
                    agcnt=int(row["agcnt"][s]),
                    bgcnt=int(row["bgcnt"][s]),
                    identity=_identity(p, score, dcnt,
                                       int(row["e_pen"][s])),
                    gap_penalty=gap_penalty, ops_rev=ops_rev)
            out.append((score, ai, bj, tr))
        return out


# ---------------------------------------------------------------------------
# per-read extension task
# ---------------------------------------------------------------------------

def _slice_cap(brem: int, W: int) -> int:
    return 2 * brem + 4 * W + 2 * band.TAIL_N + 64


def _slice_a(codes: np.ndarray, start: int, brem: int, W: int,
             circ: bool = False) -> np.ndarray:
    cap = _slice_cap(brem, W)
    if circ:
        # circular section re-feed (rtp, minialign.c:3753): the same
        # ref section is fed again past its end, i.e. codes[pos % len]
        return np.take(codes, np.arange(start, start + cap), mode="wrap")
    return codes[start:start + cap]


@dataclasses.dataclass
class _SearchState:
    """mm_search_t equivalent (minialign.c:3216-3227)."""
    cp: tuple
    tp: tuple
    rev: int
    prem: int
    pacc: int = 0
    srem: int = MM_SREM
    narrow: int = 0
    sid: int = 0
    next_arr: list = dataclasses.field(default_factory=list)


def _load_next(st: _SearchState, seeds, tglen: int, rid: int, qlen: int,
               rlen: int = 1 << 62, kk: int = 0):
    """mm_search_load_next (minialign.c:3888-3948): pick a rescue seed
    within the tglen window behind the current head."""
    if st.srem == 0:
        return False
    st.srem -= 1

    bx = st.cp[1] - (qlen if st.rev else 0)
    fu = int(_u(st.cp[0], bx))
    fv = int(_v(st.cp[0], bx))

    ofs2 = 2 * tglen
    plim = ofs2 - st.pacc
    if st.pacc > ofs2:
        st.next_arr = []
    kept = []
    for pd, sid in st.next_arr:
        if pd >= plim:
            break
        kept.append((pd + st.pacc, sid))
    st.next_arr = kept

    rcnt = 2 * st.srem
    sid = st.sid
    while sid > 0 and rcnt > 0:
        su = int(seeds[sid - 1, 0])
        sr = int(seeds[sid - 1, 1])
        sv = int(seeds[sid - 1, 2])
        if sr < rid or su + tglen < fu:
            break
        inside = (fv > sv) and (fv <= sv + tglen) and (sr == rid)
        near = (fv > sv) and (fv <= sv + 128) and (fu <= su + 128) \
            and (sr == rid)
        if inside and not near:
            pdiff = (su + tglen - fu) + (sv + tglen - fv)
            st.next_arr.append((pdiff, sid - 1))
            rcnt -= 1
        sid -= 1
    st.sid = sid
    if not st.next_arr:
        st.pacc = 0
        st.srem = 0
        return False
    # radix_sort_64x keyed on pdiff ONLY (minialign.c:3931): equal
    # pdiffs keep ksort's permutation, and the reference pops the
    # LAST element after the sort
    from .ksort import ks_radix64
    keys = np.asarray([pd & 0xFFFFFFFF for pd, _ in st.next_arr],
                      np.uint32)
    order = ks_radix64(keys)
    st.next_arr = [st.next_arr[i] for i in order]
    pdiff, nsid = st.next_arr.pop()
    st.pacc = ofs2 - pdiff

    x, y = coords_to_xy(seeds[nsid, 0], seeds[nsid, 2])
    st.rev = 1 if y < 0 else 0
    apos = x
    bpos = y + (qlen if y < 0 else 0)
    # mm_search_load_pos over-end adjustment also runs on rescue
    # loads (minialign.c:3937); rlen is current here (mm_init_ref ran
    # at the root load)
    if apos >= rlen or bpos >= qlen:
        apos -= min(apos, kk)
        bpos -= min(bpos, kk)
    st.cp = (apos, bpos)
    return st.srem > 0


def extend_read(mp: MapParams, mi: MMIndex, qcodes: np.ndarray, qid: int,
                qidx: int | None = None, tbuf: dict | None = None,
                duo: bool = False):
    """Generator: yields ('down'|'up', a, b, W) requests, receives
    (score, mi, mj, trace) via .send(). Returns (res, slots, rec) where
    res is a list of [accumulated_score, Bin] and slots the global
    aln-slot list (mm_align_seq up to the extend stage,
    minialign.c:4427-4450).

    tbuf carries the reference's per-thread-buffer state: the root
    bounds test in mm_search_load_pos (minialign.c:3828) reads
    self->rlen BEFORE mm_init_ref updates it (minialign.c:3865-3873),
    so it sees the ref length of the PREVIOUSLY loaded root — of an
    earlier chain, an earlier read, or 0 (calloc) for the very first
    root of the buffer's lifetime (one mm_align_init per index block).
    tbuf = {"rlen": <stale value>, "spec": bool}; with spec=True the
    first root of this read uses the current ref length as a guess and
    the caller replays the read if the guess disagrees with the true
    sequential value (see pipeline.align_batch). rec reports what this
    read did: its first root's raw position and fired flag, and the
    rlen it leaves behind."""
    score_p = mp.score
    qlen = len(qcodes)
    rec = {"first": None, "fired": False, "out_rlen": None}
    if tbuf is None:
        tbuf = {"rlen": 0, "spec": False}
    if qlen < mi.k or qlen * score_p.mcoef < mp.min_score:
        return None

    qf = np.ascontiguousarray(np.asarray(qcodes, np.int8))
    qr = revcomp_codes(qf)
    qrc = {0: qf, 1: qr}
    twlen = mp.wlen              # _ud(wlen, wlen) == wlen
    tglen = mp.glen

    st_seed = None
    res = []                     # [accumulated_score, Bin]
    slots = []                   # global aln slots (self->bin array)
    pos_hash = {}                # _key -> [eid, nid]
    crem = MM_CREM

    for rnd in range(len(mi.occ)):
        if rnd == 0:
            st_seed = collect_seeds(mi, qf)
        seeds = seed_round(mi, st_seed, rnd)
        if seeds is None or len(seeds) == 0:
            continue
        chains = chain_seeds(seeds, twlen, lens=mi.lens,
                             circular=mi.circular)
        if not chains:
            continue

        for ch in chains:
            if ch.plen * score_p.mcoef < 2.0 * mp.min_score:
                break
            # ---- load root (minialign.c:3839-3885)
            rsid = ch.root_sid
            x, y = coords_to_xy(seeds[rsid, 0], seeds[rsid, 2])
            rid = int(seeds[rsid, 1])
            rcodes = np.asarray(mi.codes[rid], np.int8)
            rrev = ref_revcomp(mi, rid)
            rlen = int(mi.lens[rid])
            circ = bool(mi.circular[rid])
            apos = x
            bpos = y + (qlen if y < 0 else 0)
            if rec["first"] is None:
                rec["first"] = (apos, bpos)
                fired = (apos >= (rlen if tbuf["spec"] else tbuf["rlen"])
                         or bpos >= qlen)
                rec["fired"] = fired
            else:
                fired = apos >= tbuf["rlen"] or bpos >= qlen
            if fired:
                apos -= min(apos, mi.k)
                bpos -= min(bpos, mi.k)
            tbuf["rlen"] = rlen
            rec["out_rlen"] = rlen
            st = _SearchState(cp=(apos, bpos), tp=(apos, bpos),
                              rev=1 if y < 0 else 0, prem=ch.plen,
                              sid=rsid)
            eid = len(res)
            bin_ = Bin()
            res.append([0, bin_])
            slots_mark = len(slots)

            first = True
            while st.srem > 0 and st.prem > 0:
                if not first:
                    if not _load_next(st, seeds, tglen, rid, qlen,
                                      rlen=rlen, kk=mi.k):
                        break
                first = False
                W = WIDTHS[st.narrow]
                qdir = qrc[st.rev]

                # ---- downward extension (+ fused speculative up:
                # one device round per trial when the store path and
                # non-circular geometry allow — mm_extend_core's
                # down/up pair, minialign.c:4075-4147)
                cap = _slice_cap(qlen - st.cp[1], W)
                use_duo = (duo and qidx is not None and not circ
                           and st.cp[0] >= 0 and st.cp[1] >= 0)
                if use_duo:
                    a = ("ref", rid, 0, st.cp[0], cap, 0)
                    b = ("q", qidx, st.rev, st.cp[1])
                    meta = (rid, st.rev, qidx, rlen, qlen,
                            st.cp[0], st.cp[1])
                    sc, mi_, mj_, usc, umi, umj, tr = yield (
                        "duo", a, b, W, meta)
                else:
                    if qidx is not None:
                        a = ("ref", rid, 0, st.cp[0], cap,
                             rlen if circ else 0)
                        b = ("q", qidx, st.rev, st.cp[1])
                    else:
                        a = _slice_a(rcodes, st.cp[0], qlen - st.cp[1],
                                     W, circ)
                        b = qdir[st.cp[1]:]
                    sc, mi_, mj_, _ = yield ("down", a, b, W)
                if sc == 0:
                    continue
                ae, be = st.cp[0] + mi_, st.cp[1] + mj_
                if circ and ae > rlen:
                    # gaba reports the max within the re-fed section;
                    # fold the unwrapped end back (pos in (0, rlen])
                    ae = ((ae - 1) % rlen) + 1
                # test_dup (minialign.c:3953-3994), clip to [1, len]
                st.tp = (min(max(ae, 1), rlen), min(max(be, 1), qlen))
                k = _poskey(ae, be, rid, qid)
                dup = k in pos_hash
                pos_hash[k] = [eid, -1]
                if dup:
                    # the fused path's speculative up result is simply
                    # discarded — byte-neutral vs the two-step skip
                    st.narrow = min(st.narrow + 1, 2)
                    continue

                if not use_duo:
                    # ---- upward extension on reversed sequences
                    W0 = WIDTHS[0]
                    capu = _slice_cap(st.tp[1], W0)
                    if qidx is not None:
                        au = ("ref", rid, 1, rlen - st.tp[0], capu,
                              rlen if circ else 0)
                        # revcomp(qdir) is just the OTHER strand copy
                        bu = ("q", qidx, 1 - st.rev, qlen - st.tp[1])
                    else:
                        au = _slice_a(rrev, rlen - st.tp[0], st.tp[1],
                                      W0, circ)
                        bu = revcomp_codes(qdir)[qlen - st.tp[1]:]
                    usc, umi, umj, tr = yield ("up", au, bu, W0)
                if usc < mp.min_score or tr is None:
                    continue

                ae, be = st.tp
                as0_u, bs0 = ae - umi, be - umj
                segs = split_segments(as0_u, bs0, tr.path_rev, rlen,
                                      ops=list(tr.ops_rev) or None) \
                    if (circ and as0_u < 0) else None
                as0 = segs[0].as0 if segs else as0_u
                aln = Aln(rid=rid, rev=st.rev, as0=as0, ae=ae,
                          bs0=bs0, be=be, score=usc, path=tr.path_rev,
                          identity=tr.identity, dcnt=tr.dcnt,
                          agcnt=tr.agcnt, bgcnt=tr.bgcnt, segs=segs,
                          upath=tr.path)

                # ---- record (minialign.c:4018-4067)
                st.cp = (as0, bs0)
                st.prem -= aln.plen
                st.pacc = aln.plen
                hk = _poskey(as0, bs0, rid, qid)
                tk = _poskey(ae, be, rid, qid)
                hent = pos_hash.get(hk)
                new = hent is None or hent[1] == -1 \
                    or hent[1] >= len(slots)        # stale after rollback
                if new:
                    nid = len(slots)
                    slots.append(aln)
                    bin_.slot_idx.append(nid)
                else:
                    nid = hent[1]
                ovl = ((max(bin_.lb, bs0) - min(bin_.ub, be)
                        - bs0 + be) & 0xFFFFFFFF)
                res[eid][0] += aln.score + int((ovl * 2) * aln.identity)
                bin_.n_aln += 1 if new else 0
                bin_.plen += aln.plen
                bin_.lb = min(bin_.lb, bs0)
                bin_.ub = max(bin_.ub, be)
                if (not new) and slots[nid].score > aln.score:
                    pos_hash[tk] = [eid, -1]
                else:
                    if not new:
                        slots[nid] = aln
                    pos_hash[hk] = [eid, nid]
                    pos_hash[tk] = [eid, nid]
                st.srem, st.narrow = MM_SREM, 0
                if (not new) or st.prem <= 0:
                    break

            # ---- finish root (minialign.c:3795-3811)
            if bin_.n_aln == 0 or res[eid][0] < mp.min_score:
                res.pop()
                del slots[slots_mark:]
                crem -= 1
            else:
                crem = MM_CREM if crem != 0 else 0
            if crem == 0:
                break
        if res:
            break

    if not res:
        return None, None, rec
    return res, slots, rec
