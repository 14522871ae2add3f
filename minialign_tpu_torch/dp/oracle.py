"""Copy of minialign_tpu/dp/oracle.py for the port, unchanged apart from
this header (its imports are relative, so they resolve in this package).

Naive full-matrix semi-global DP oracle.

This is the ground truth for validating the banded kernels, mirroring the
reference's `unittest_naive` (gaba.c:4638-4778): semi-global alignment
anchored at the origin, piecewise-affine ("combined") gap model, max over
all cells with (min i+j, then min j) tie-breaking, and a traceback with
the documented M > I > D priority: on score ties the vertical (query-
consuming, 'D' in the naive path alphabet) gap is taken first, then the
horizontal ('R') gap, then the diagonal; within gap runs the gap is
closed at the earliest opening (left-aligned gaps).

Unlike the reference naive (which collapses the matrix to max/min
scores), this oracle uses the full 4x4(+N) substitution matrix, matching
the real kernel's shuffle-table lookup (gaba.c:846-952).

Path alphabet ('D'/'R') follows the reference naive: 'D' advances b (the
query side), 'R' advances a (the reference side). A diagonal step is the
pair "DR". In gaba path-bit terms D=1, R=0 (gaba_parse.h:124-130).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import ScoreParams

NEG = np.int64(-(1 << 40))


@dataclasses.dataclass
class OracleResult:
    score: int
    alen: int          # i* = number of a (ref) bases consumed
    blen: int          # j* = number of b (query) bases consumed
    path: str          # 'D'/'R' string, forward order


def _fill(p: ScoreParams, a: np.ndarray, b: np.ndarray):
    """Anti-diagonal full-matrix fill. Returns (S, E, F) matrices of
    shape (alen+1, blen+1) plus the max (score, i, j)."""
    sub = p.matrix55()                      # [query b, ref a]
    gi, ge = p.gi, p.ge
    gfa, gfb = p.gfa_eff, p.gfb_eff
    # the naive clamps S at a floor (gaba.c:4668)
    floor = np.int64(np.iinfo(np.int16).min - p.min_match - 2 * gi)

    la, lb = len(a), len(b)
    S = np.full((la + 1, lb + 1), NEG, dtype=np.int64)
    E = np.full((la + 1, lb + 1), NEG, dtype=np.int64)
    F = np.full((la + 1, lb + 1), NEG, dtype=np.int64)

    i0 = np.arange(1, la + 1, dtype=np.int64)
    j0 = np.arange(1, lb + 1, dtype=np.int64)
    S[0, 0] = E[0, 0] = F[0, 0] = 0
    S[1:, 0] = E[1:, 0] = np.maximum(floor,
                                     np.maximum(-gi - i0 * ge, -i0 * gfb))
    F[1:, 0] = floor
    S[0, 1:] = F[0, 1:] = np.maximum(floor,
                                     np.maximum(-gi - j0 * ge, -j0 * gfa))
    E[0, 1:] = floor

    # substitution score of cell (i, j) (1-based): sub[b[j-1], a[i-1]]
    subm = sub[b[None, :], a[:, None]].astype(np.int64)  # (la, lb)

    best = (np.int64(0), 0, 0)  # (score, i, j); empty alignment scores 0
    for d in range(2, la + lb + 1):
        ilo = max(1, d - lb)
        ihi = min(la, d - 1)
        if ilo > ihi:
            continue
        i = np.arange(ilo, ihi + 1)
        j = d - i
        e = np.maximum(S[i - 1, j] - gi, E[i - 1, j]) - ge
        f = np.maximum(S[i, j - 1] - gi, F[i, j - 1]) - ge
        s = np.maximum(S[i - 1, j - 1] + subm[i - 1, j - 1],
                       np.maximum(np.maximum(e, S[i - 1, j] - gfb),
                                  np.maximum(f, S[i, j - 1] - gfa)))
        s = np.maximum(s, floor)
        E[i, j] = e
        F[i, j] = f
        S[i, j] = s
        k = int(np.argmax(s))           # first max = min j? i ascending...
        # within an anti-diagonal, ties prefer min j = max i; argmax
        # returns the first (min i = max j). Scan for the right one:
        mx = s[k]
        if mx > best[0]:
            # pick min-j (max-i) among ties on this diagonal
            kk = len(s) - 1 - int(np.argmax(s[::-1]))
            best = (np.int64(mx), int(i[kk]), int(j[kk]))
    return S, E, F, best


def oracle_extend(p: ScoreParams, a: np.ndarray, b: np.ndarray) -> OracleResult:
    """Semi-global extension of query b against reference a, both given
    as code arrays (0..3, 4=N), anchored before (a[0], b[0])."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    S, E, F, (score, ai, bj) = _fill(p, a, b)
    if score <= 0:
        return OracleResult(score=int(max(score, 0)), alen=0, blen=0, path="")

    gi, ge = p.gi, p.ge
    gfa, gfb = p.gfa_eff, p.gfb_eff
    path = []
    i, j = ai, bj
    # traceback priority per gaba.c:4721-4762
    while i > 0 or j > 0:
        if j > 1 and S[i, j] == S[i, j - 1] - gfa:
            j -= 1
            path.append("D")
        elif S[i, j] == F[i, j]:
            while j > 1 and F[i, j] != S[i, j - 1] - gi - ge:
                j -= 1
                path.append("D")
            j -= 1
            path.append("D")
        elif i > 1 and S[i, j] == S[i - 1, j] - gfb:
            i -= 1
            path.append("R")
        elif S[i, j] == E[i, j]:
            while i > 1 and E[i, j] != S[i - 1, j] - gi - ge:
                i -= 1
                path.append("R")
            i -= 1
            path.append("R")
        else:
            path.append("R")
            path.append("D")
            i -= 1
            j -= 1
    return OracleResult(score=int(score), alen=ai, blen=bj,
                        path="".join(reversed(path)))


def path_to_cigar(path: str) -> str:
    """Convert a 'D'/'R' path to a CIGAR string (D=query base -> I,
    R=ref base -> D, DR pair -> M), matching gaba_dump_cigar output
    conventions (gaba_parse.h:148-170: I runs before D runs at run
    boundaries in forward parse)."""
    out = []
    idx, n = 0, len(path)
    while idx < n:
        # insertion run (query-only, 'D' in naive alphabet)
        c = 0
        while idx < n and path[idx] == "D" and not (
                idx + 1 < n and path[idx + 1] == "R"):
            c += 1
            idx += 1
        if c:
            out.append(f"{c}I")
        # deletion run
        c = 0
        while idx < n and path[idx] == "R":
            c += 1
            idx += 1
        if c:
            out.append(f"{c}D")
        # diagonal run
        c = 0
        while idx + 1 < n and path[idx] == "D" and path[idx + 1] == "R":
            c += 1
            idx += 2
        if c:
            out.append(f"{c}M")
        elif idx < n and path[idx] == "D" and (idx + 1 == n):
            out.append("1I")
            idx += 1
    return "".join(out)
