"""What decides `correct`: the SAM records that the timed window printed
for a sample of its reads, and the program's index over a sample of the
genome, held against the plain reference (reference.py).

Numbers compared, each against the cell's limit (limits/<cell>.json):

- missing: sampled reads that the window read and printed no record for.
- malformed: sampled reads whose primary record is not a record of that
  read: fewer than 11 fields, another name or reference, SEQ other than
  the read (reverse-complemented on the reverse strand), a CIGAR whose
  query length is not the read's, or a reference span off the genome.
- misplaced: mapped primaries on the wrong strand, or whose reference
  span does not overlap the read's true origin.
- unmapped_hi: reads of accuracy >= 0.85 and >= 2 kb left unmapped (on
  a random genome every such read has one place, and seeds to find it).
- seg_gap: the widest shortfall, in score points, of the program's path
  against the best path between the same two of its points, over up to
  four segments of 1,024 query bases a read (its first, its last, two
  drawn from the seed): the band DP of reference.py, global, in int32,
  within a band that holds the program's path.
- index_diff: minimizer entries (hash, position, strand) in which the
  program's index and reference.sketch differ, over sampled 4 kb blocks
  of the genome.
"""

from __future__ import annotations

import numpy as np

from . import reference as R
from .gen import BASES

SEG = 1024
SEG_PER_READ = 4
BLOCK = 4096
CHECKS = ("missing", "malformed", "misplaced", "unmapped_hi", "seg_gap",
          "index_diff")


def sample(rng: np.random.Generator, lengths: np.ndarray, n_rand: int,
           n_long: int) -> list:
    """Pool indices to judge: n_rand drawn at random and the n_long
    longest, ascending."""
    n = len(lengths)
    pick = set(rng.choice(n, min(n_rand, n), replace=False).tolist())
    pick |= set(np.argsort(-lengths, kind="stable")[:n_long].tolist())
    return sorted(pick)


def _primary(i: int, text: str, read: np.ndarray, gname: str, glen: int):
    """(flag, 0-based position, CIGAR ops) of read i's primary, or
    None when no primary record of read i is there."""
    for line in text.splitlines():
        f = line.split("\t")
        if len(f) < 11 or f[0] != f"r{i}" or not f[1].isdigit():
            return None
        flag = int(f[1])
        if flag & 0x900:
            continue
        if flag & 4:
            ok = f[9] == BASES[read].tobytes().decode()
            return (flag, None, None) if ok else None
        rev = bool(flag & 16)
        q = (3 - read[::-1]) if rev else read
        if f[2] != gname or f[9] != BASES[q].tobytes().decode():
            return None
        try:
            ops = R.parse_cigar(f[5])
            pos = int(f[3]) - 1
        except ValueError:
            return None
        qlen = sum(n for n, op in ops if op in "MIS=X")
        rlen = sum(n for n, op in ops if op in "MD=X")
        if qlen != len(read) or pos < 0 or pos + rlen > glen:
            return None
        return flag, pos, ops
    return None


def _segments(rng, kinds, r, q):
    """Column ranges [c0, c1) of up to SEG_PER_READ segments of about SEG
    query bases, each cut just before an M column (or at the end), so that
    no gap run is cut."""
    if len(kinds) == 0:
        return []
    mcols = np.flatnonzero(kinds == 0)
    if len(mcols) == 0:
        return []
    qend = int(q[-1])
    starts = [0, max(0, qend - SEG)]
    starts += [int(x) for x in rng.integers(0, max(1, qend - SEG), 2)]
    out = []
    for qa in starts[:SEG_PER_READ]:
        k0 = np.searchsorted(q[mcols], qa)
        if k0 >= len(mcols):
            continue
        c0 = int(mcols[k0])
        k1 = np.searchsorted(q[mcols], q[c0] + SEG)
        c1 = int(mcols[k1]) if k1 < len(mcols) else len(kinds)
        if c1 > c0:
            out.append((c0, c1))
    return out


def judge(score: dict, genome: np.ndarray, gname: str, pool, picks: list,
          seen: set, records: dict, rng: np.random.Generator,
          index=None, k: int = 15, w: int = 10, n_blocks: int = 16,
          device="cpu") -> tuple[dict, int, int]:
    """({check: value}, reads judged, reads failed). `records` maps pool
    index -> the SAM text printed for it; `seen` holds the pool indices
    that the window read; `index` is the program's MMIndex (None: the
    index is not judged)."""
    v = dict.fromkeys(CHECKS, 0)
    glen = len(genome)
    judged = failed = 0
    refs, qrys, scores = [], [], []
    for i in picks:
        if i not in seen:
            continue
        judged += 1
        if i not in records:
            v["missing"] += 1
            failed += 1
            continue
        read = pool.codes(i)
        p = _primary(i, records[i], read, gname, glen)
        if p is None:
            v["malformed"] += 1
            failed += 1
            continue
        flag, pos, ops = p
        if flag & 4:
            if pool.acc[i] >= 0.85 and pool.length[i] >= 2000:
                v["unmapped_hi"] += 1
            continue
        rev = bool(flag & 16)
        kinds, r, q = R.columns(ops)
        st, ln = int(pool.start[i]), int(pool.length[i])
        if rev != bool(pool.rev[i]) or pos >= st + ln or pos + r[-1] <= st:
            v["misplaced"] += 1
            failed += 1
        clip = ops[0][0] if ops[0][1] == "S" else 0
        qo = ((3 - read[::-1]) if rev else read)[clip:]
        ro = genome[pos:]
        for c0, c1 in _segments(rng, kinds, r, q):
            rs, re_, qs, qe = r[c0], r[c1], q[c0], q[c1]
            refs.append(ro[rs:re_])
            qrys.append(qo[qs:qe])
            kk = kinds[c0:c1]
            rr, qq = r[c0:c1 + 1] - rs, q[c0:c1 + 1] - qs
            scores.append((R.path_score(score, kk, refs[-1], qrys[-1], rr, qq),
                           _deviation(rr, qq)))
    if refs:
        half = min(1024, -(-(max(d for _, d in scores) + 16) // 16) * 16)
        half = max(half, 32)
        opt, _ = R.band_dp(score, refs, qrys, half, device=device)
        v["seg_gap"] = int(max(int(o) - s for o, (s, _) in zip(opt, scores)))
    if index is not None:
        v["index_diff"] = index_diff(genome, index, rng, k, w, n_blocks)
    else:
        del v["index_diff"]
    return v, judged, failed


def _deviation(r: np.ndarray, q: np.ndarray) -> int:
    """How far the path's points lie from the band centre that band_dp
    uses for this segment: ref offset against round(q * m / n)."""
    m, n = int(r[-1]), max(int(q[-1]), 1)
    c = (q * m * 2 + n) // (2 * n)
    return int(np.abs(r - c).max())


def index_diff(genome: np.ndarray, mi, rng: np.random.Generator, k: int,
               w: int, n_blocks: int) -> int:
    """Entries in which the index's minimizers of sequence 0 and the
    reference sketch differ, over n_blocks blocks of BLOCK bases."""
    nb = max(1, len(genome) // BLOCK)
    blocks = np.sort(rng.choice(nb, min(n_blocks, nb), replace=False))
    vp = np.asarray(mi.vals_pos)
    vr = np.asarray(mi.vals_rid)
    sel = np.flatnonzero(np.isin(vp // BLOCK, blocks) & ((vr >> 1) == 0))
    off = np.asarray(mi.offsets, np.int64)
    kidx = np.searchsorted(off, sel, side="right") - 1
    prog = set(zip(np.asarray(mi.keys)[kidx].tolist(), vp[sel].tolist(),
                   (vr[sel] & 1).tolist()))
    ref = set()
    for b in blocks.tolist():
        h, pos, strand = R.sketch_region(genome, k, w, b * BLOCK,
                                         (b + 1) * BLOCK)
        ref |= set(zip(h.tolist(), pos.tolist(), strand.tolist()))
    return len(prog ^ ref)
