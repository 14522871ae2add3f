"""Post-processing: prune, supplementary collection, mapq.

Ports of mm_prune_regs / mm_collect_supp / mm_post_map / mm_post_ava
(minialign.c:4175-4355). The mapq math must match the reference for
SAM equality: unique-length estimate ulen = ec * max(score - usc, 0)
with ec = 2 / (pid*(mcoef+xcoef) - xcoef), pe = 1/(ulen^2+1), mapq =
clip(-10 * 16 * log10(pe)) stored x16 (MAPQ_COEF) and printed >> 4.

Carried from the JAX package's minialign_tpu/post.py unchanged; only
the imports differ (the JAX module reaches jax through its extend/band
imports).
"""

from __future__ import annotations

import math

from .extend import Bin
from .params import MAPQ_COEF, MapParams


OFS = 0x40000000


def _clip(x: float) -> int:
    """_clip (minialign.c:4177): MAX2(0, MIN2((uint32_t)(x), 960)).
    (uint32_t) of NaN / negative / huge doubles on x86-64 (cvttsd2si)
    yields 0x80000000, which MIN2 clips to 960 — replicate that."""
    if math.isnan(x) or x >= 2**63 or x < 0 or int(x) >= 2**32:
        return 60 * MAPQ_COEF
    return max(0, min(int(x), 60 * MAPQ_COEF))


def prune_regs(res: list, min_ratio: float) -> list:
    """mm_prune_regs (minialign.c:4185-4207): res sorted by score desc;
    keep entries with score >= uint32(score0 * min_ratio)."""
    if not res:
        return res
    min_real = int(res[0][0] * min_ratio)
    q = len(res)
    while q > 1 and res[q - 1][0] < min_real:
        q -= 1
    return res[:q]


def collect_supp(res: list) -> int:
    """mm_collect_supp (minialign.c:4214-4263): partition primary +
    supplementary (prefix) vs secondary (suffix) by query-interval
    coverage; returns p = #primary+supplementary."""
    p, q = 1, len(res)
    while p < q:
        mx = 0                   # uint64 ((2*(ub-lb)-span)<<32 | i)
        i = p
        while i < q:
            s: Bin = res[i][1]
            lb, ub = s.lb, s.ub
            span = ub - lb
            covered = False
            for j in range(p):
                t: Bin = res[j][1]
                if t.ub < ub:
                    lb = max(lb, t.ub)
                else:
                    ub = min(ub, t.lb)
                if 1.2 * (ub - lb) < span:
                    q -= 1
                    res[i], res[q] = res[q], res[i]
                    i -= 1
                    covered = True
                    break
            if not covered:
                key = ((2 * (ub - lb) - span) << 32 | i) & ((1 << 64) - 1)
                mx = max(mx, key)
            i += 1
        if mx & 0xFFFFFFFF:
            k = mx & 0xFFFFFFFF
            res[p], res[k] = res[k], res[p]
        p += 1
    return min(p, q)


def post_map(mp: MapParams, res: list, slots: list) -> int:
    """mm_post_map (minialign.c:4270-4325): set Bin.mapq (x16), return
    #non-repetitive alignments."""
    p = collect_supp(res)

    usc, lsc, tsc = 0, None, 0
    for i in range(p, len(res)):
        sc = res[i][0]
        usc = max(usc, sc)
        lsc = sc if lsc is None else min(lsc, sc)
        tsc += sc
    lsc = 0 if lsc is None else lsc

    x = mp.score.xcoef
    mx = mp.score.mcoef + mp.score.xcoef
    tpc = 1.0
    for i in range(p):
        sc, bin_ = res[i]
        length = sum(slots[j].plen for j in bin_.slot_idx)
        pid = sum(slots[j].plen * slots[j].identity
                  for j in bin_.slot_idx) / length if length else 0.0
        denom = pid * mx - x
        ec = 2.0 / denom if denom != 0 else 0.0
        ulen = ec * max(sc - usc, 0)
        pe = 1.0 / (ulen * ulen + 1)
        bin_.mapq = _clip(-10.0 * MAPQ_COEF * math.log10(pe))
        tpc *= 1.0 - pe

    tpe = min(1.0 - tpc, 1.0)
    for i in range(p, len(res)):
        sc, bin_ = res[i]
        # the reference mixes score spaces here (minialign.c:4322):
        # res[i].score is the OFFSETTED uint32 (0x40000000 - acc) while
        # lsc/tsc are real; replicated verbatim for mapq byte equality
        sc_ofs = (OFS - sc) & 0xFFFFFFFF
        frac = tpe * float(sc_ofs - lsc + 1) / float(tsc) if tsc else 0.0
        v = 1.0 - frac
        bin_.mapq = _clip(-10.0 * MAPQ_COEF * math.log10(v)) if v > 0 \
            else 60 * MAPQ_COEF
    return p


def post_ava(mp: MapParams, res: list, slots: list) -> int:
    """mm_post_ava (minialign.c:4332-4355)."""
    x = mp.score.xcoef
    mx = mp.score.mcoef + mp.score.xcoef
    min_sc = res[0][0] * mp.min_ratio if res else 0
    for sc, bin_ in res:
        if sc < min_sc:
            break
        length = sum(slots[j].plen for j in bin_.slot_idx)
        pid = sum(slots[j].plen * slots[j].identity
                  for j in bin_.slot_idx) / length if length else 0.0
        denom = pid * mx - x
        ec = 2.0 / denom if denom != 0 else 0.0
        ulen = ec * sc
        pe = 1.0 / (ulen + 1)
        bin_.mapq = _clip(-10.0 * MAPQ_COEF * math.log10(pe))
    return len(res)
