"""Host-side traceback over the fill's band mask buffers.

Carries TraceResult, _identity, traceback_one, traceback_batch and
calc_score (the gaba_dp_calc_score validator) from
minialign_tpu/dp/traceback.py unchanged; only the imports differ (the
JAX module reaches jax through its band constants). See that module for
the walk's semantics and reference citations.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import ScoreParams
from .band import BLK, M_E, M_EO, M_F, M_FO, M_GFA, M_GFB


@dataclasses.dataclass
class TraceResult:
    score: int
    alen: int              # ref bases consumed (i*)
    blen: int              # query bases consumed (j*)
    path: str              # 'D' (query) / 'R' (ref) ops, forward order
    path_rev: str          # op order reversed with diagonals kept as
                           # atomic "DR" pairs — the forward-space path
                           # when this problem aligned reversed
                           # sequences (the reference gets the same by
                           # reverse-parsing the stored bit path,
                           # minialign.c:5161 gaba_dump_cigar_reverse)
    dcnt: int              # diagonal count
    agcnt: int             # gap bases on a (ref consumed in gaps = R ops)
    bgcnt: int             # gap bases on b
    identity: float
    gap_penalty: int       # total gap penalty (positive)
    ops_rev: str = ""      # walker tokens in pop order: 'X' diagonal
                           # pair / 'R' / 'D'; circular segment splits
                           # depend on these (see extend.split_segments)

    @property
    def plen(self) -> int:
        return len(self.path)


def _identity(p: ScoreParams, score: int, dcnt: int, gap_penalty: int) -> float:
    """identity = ((score + gaps)/dlen - x) / (m - x) (gaba.c:3336-3352).

    Empirically (probed against the reference binary with controlled
    indel reads), only the REF-SIDE (deletion / E-branch) gap penalties
    are added back into dsc; query-side (insertion) gaps are not. The
    gap_penalty argument must therefore be the ref-side total only."""
    if dcnt == 0:
        return 0.0
    imx, xmx = p.imx_xmx
    dsc = score + gap_penalty
    # op order matters for bit-equal trunc(dcnt*identity) downstream:
    # (dsc/dlen)*imx - xmx with precomputed imx/xmx (gaba.c:3353)
    return (dsc / dcnt) * imx - xmx


def traceback_one(p: ScoreParams, W: int,
                  masks: np.ndarray,    # (NB, BLK, 16) uint32 cell codes
                  dirs: np.ndarray,     # (NB,) uint32
                  iheads: np.ndarray,   # (NB,) int32
                  score: int, ai: int, bj: int) -> TraceResult | None:
    if score <= 0 or (ai == 0 and bj == 0):
        return TraceResult(score=max(score, 0), alen=0, blen=0, path="",
                           path_rev="",
                           dcnt=0, agcnt=0, bgcnt=0, identity=0.0,
                           gap_penalty=0)

    from .. import native
    if native.available():
        r = native.trace_one(p, W, masks, dirs, int(iheads[0]),
                             int(score), int(ai), int(bj))
        if r is None:
            return None
        path, path_rev, dcnt, agcnt, bgcnt, gap_penalty, e_pen, \
            ops_rev = r
        return TraceResult(score=score, alen=ai, blen=bj, path=path,
                           path_rev=path_rev, dcnt=dcnt, agcnt=agcnt,
                           bgcnt=bgcnt,
                           identity=_identity(p, score, dcnt, e_pen),
                           gap_penalty=gap_penalty, ops_rev=ops_rev)

    nb = dirs.shape[0]
    # per-step direction bits and ihead values
    steps = nb * BLK
    dbits = ((dirs[:, None] >> np.arange(BLK, dtype=np.uint32)[None, :])
             & 1).astype(np.int8).reshape(-1)          # (steps,)
    rights = 1 - dbits
    ihead_after = np.empty(steps + 1, np.int64)
    ihead_after[0] = iheads[0]                          # ihead at p=-1
    np.cumsum(rights, out=ihead_after[1:])
    ihead_after[1:] += iheads[0]
    # ihead_after[s+1] == ihead after step s (band p = s)

    def ihead_at(pp):                                   # band p >= -1
        return int(ihead_after[pp + 1])

    def dir_at(pp):                                     # move creating band p
        return int(dbits[pp]) if pp >= 0 else 0         # p=-1 was a down

    def mbit(pp, mi, qq):
        w = masks[pp // BLK, pp % BLK, qq & 15]
        return (int(w) >> (((qq >> 4) << 3) + mi)) & 1

    gi, ge = p.gi, p.ge
    i, j = int(ai), int(bj)
    pp = i + j - 2
    q = ihead_at(pp) - i
    if not (0 <= q < W):
        return None

    ops = []                     # built backward
    dcnt = agcnt = bgcnt = 0
    n_open = 0                   # affine gap regions (both sides)
    n_ext = 0                    # affine gap bases (both sides)
    n_gf = 0                     # linear (gf) gap bases (both sides)
    gf_pen = 0
    e_pen = 0                    # ref-side (R/E) gap penalty only: the
                                 # component the reference adds back
                                 # into the identity estimate

    def move_f():                # (i, j) -> (i, j-1)
        nonlocal j, pp, q
        q = q - (0 if dir_at(pp) == 1 else 1)
        j -= 1
        pp -= 1

    def move_e():                # (i, j) -> (i-1, j)
        nonlocal i, pp, q
        q = q + (1 if dir_at(pp) == 1 else 0)
        i -= 1
        pp -= 1

    def move_diag():
        nonlocal i, j, pp, q
        q = q + (1 if dir_at(pp) == 1 else 0) \
              - (1 if dir_at(pp - 1) == 0 else 0)
        i -= 1
        j -= 1
        pp -= 2

    head = True                  # gaba starts in state ts_d (d_head)
    while i > 0 or j > 0:
        if i == 0:
            # leading gap on the query side: exact boundary penalty
            ops.append("D" * j)
            bgcnt += j
            aff = gi + j * ge
            if p.model == 2 and p.gfa * j < aff:
                n_gf += j
                gf_pen += p.gfa * j
            else:
                n_open += 1
                n_ext += j
            break
        if j == 0:
            ops.append("R" * i)
            agcnt += i
            aff = gi + i * ge
            if p.model == 2 and p.gfb * i < aff:
                n_gf += i
                gf_pen += p.gfb * i
                e_pen += p.gfb * i
            else:
                n_open += 1
                n_ext += i
                e_pen += aff
            break
        if not (0 <= q < W):
            return None
        # gaba's trace_core state machine (gaba.c:3123-3207, COMBINED
        # model tests at gaba.c:2966-2972): horizontal (R/ref) gaps are
        # tested in the d_head state, vertical (D/query) gaps only in
        # the d_tail state (entered after a diagonal pair or a v-gap);
        # gap kind and affine-run extent come from the folded bits
        #   h = gh|gfh, e = (gh & ~gfh) | open_next   (gaba.c:1620/1631)
        # with a run continuing while NOT (h == 0 and e == 1) at the
        # arrived cell, and the gf (one-base) branch taken at a gap
        # head when e == 0.
        if head:
            if mbit(pp, M_E, q) or mbit(pp, M_GFB, q):
                eb = (mbit(pp, M_E, q) & (1 - mbit(pp, M_GFB, q))) \
                    | mbit(pp, M_EO, q)
                if not eb:
                    ops.append("R")
                    agcnt += 1
                    n_gf += 1
                    gf_pen += p.gfb_eff
                    e_pen += p.gfb_eff
                    move_e()
                else:
                    n_open += 1
                    e_pen += gi
                    while True:
                        ops.append("R")
                        agcnt += 1
                        n_ext += 1
                        e_pen += ge
                        move_e()
                        if i <= 0:
                            break
                        if not (0 <= q < W):
                            return None
                        hb = mbit(pp, M_E, q) | mbit(pp, M_GFB, q)
                        eb = (mbit(pp, M_E, q)
                              & (1 - mbit(pp, M_GFB, q))) \
                            | mbit(pp, M_EO, q)
                        if not hb and eb:
                            break
            else:
                ops.append("RD")     # backward: R then D = fwd "DR"
                dcnt += 1
                move_diag()
                head = False
        else:
            if mbit(pp, M_F, q) or mbit(pp, M_GFA, q):
                fb = (mbit(pp, M_F, q) & (1 - mbit(pp, M_GFA, q))) \
                    | mbit(pp, M_FO, q)
                if not fb:
                    ops.append("D")
                    bgcnt += 1
                    n_gf += 1
                    gf_pen += p.gfa_eff
                    move_f()
                else:
                    n_open += 1
                    while True:
                        ops.append("D")
                        bgcnt += 1
                        n_ext += 1
                        move_f()
                        if j <= 0:
                            break
                        if not (0 <= q < W):
                            return None
                        vb = mbit(pp, M_F, q) | mbit(pp, M_GFA, q)
                        fb = (mbit(pp, M_F, q)
                              & (1 - mbit(pp, M_GFA, q))) \
                            | mbit(pp, M_FO, q)
                        if not vb and fb:
                            break
            else:
                head = True
                continue
        if not (-1 <= q <= W):
            return None

    path = "".join(ops)[::-1]
    path_rev = "".join("DR" if op == "RD" else op for op in ops)
    ops_rev = "".join("X" if op == "RD" else op for op in ops)
    gap_penalty = n_open * gi + n_ext * ge + gf_pen
    return TraceResult(score=score, alen=ai, blen=bj, path=path,
                       path_rev=path_rev,
                       dcnt=dcnt, agcnt=agcnt, bgcnt=bgcnt,
                       identity=_identity(p, score, dcnt, e_pen),
                       gap_penalty=gap_penalty, ops_rev=ops_rev)


def traceback_batch(p: ScoreParams, W: int, bufs, res) -> list:
    """Trace every problem in a batch. bufs/res are numpy-converted
    TraceBuffers/FillResult."""
    out = []
    B = res.max_score.shape[0]
    for k in range(B):
        out.append(traceback_one(
            p, W, np.asarray(bufs.masks[k]), np.asarray(bufs.dirs[k]),
            np.asarray(bufs.iheads[k]), int(res.max_score[k]),
            int(res.max_i[k]), int(res.max_j[k])))
    return out


def calc_score(p: ScoreParams, path: str, rcodes: np.ndarray,
               qcodes: np.ndarray) -> dict:
    """Recompute score and counts by re-walking a forward path against
    the raw sequences (gaba_dp_calc_score, gaba.c:3489-3560 — a
    validation utility, not on the hot path). Gap runs price as the DP
    would: min(gi + n*ge, n*gf) per contiguous run under the combined
    model, affine otherwise."""
    mat = p.matrix44()
    n_sub = -2 * (p.gi + p.ge)
    score = 0
    mcnt = xcnt = agcnt = bgcnt = 0
    ri = qi = i = 0
    n = len(path)
    while i < n:
        if i + 1 < n and path[i] == "D" and path[i + 1] == "R":
            a, b = int(rcodes[ri]), int(qcodes[qi])
            if a >= 4 or b >= 4:
                score += n_sub
                xcnt += 1
            else:
                score += int(mat[b, a])
                mcnt += 1 if a == b else 0
                xcnt += 0 if a == b else 1
            ri += 1
            qi += 1
            i += 2
            continue
        op = path[i]
        run = 0
        while i < n and path[i] == op and not (
                op == "D" and i + 1 < n and path[i + 1] == "R"):
            run += 1
            i += 1
        aff = p.gi + run * p.ge
        gf = p.gfa if op == "D" else p.gfb
        cost = min(aff, gf * run) if p.model == 2 and gf else aff
        score -= cost
        if op == "D":
            bgcnt += run
            qi += run
        else:
            agcnt += run
            ri += run
    return dict(score=score, mcnt=mcnt, xcnt=xcnt, agcnt=agcnt,
                bgcnt=bgcnt)
