"""The plain reference of the all-vs-all overlap cell: which reads truly
overlap, where, on which strand, and the alignment scores of the
linear-gap model, worked out again from the seed's genome and read pool.
It imports nothing of the program under test; it uses the harness's
generator (gen.py) and the plain reference of the map cells
(reference.py: `sketch`, `band_dp`, `path_score`).

- `read_map`: where each source base of a read landed in the read. The
  generator's mutation draws one uniform number a source base first
  (gen.mutate): below the error rate's substitution share it is a
  substitution, then a deletion, then an insertion after the base. The
  draw alone fixes every base's place, so it is drawn again here.
- `true_overlaps`: the reads whose genome intervals intersect read i's,
  with the intersection in both reads' coordinates and the relative
  strand ('+' where both reads lie on the same strand of the genome).
  Query coordinates on '-' are on the reverse complement of the query,
  target coordinates on the target as written: minialign's PAF
  (minialign.c:5583-5584).
- `project`: where a query coordinate of an alignment lands on the
  target under the true correspondence of the two reads' bases, so that
  a line's ends can be held to the true diagonal.
- `linear_score`: the configuration's scores in the form that
  reference.py takes. Its gap cost is min(gi + ge * l, gf * l); with
  gi = 0 and gf = ge that is ge * l, the linear model (gaba's model row
  for gi = 0, gaba_wrap.h:208-222).

Set TF32 off, as every float32 product here would otherwise risk: the
reference computes in integers, so nothing depends on it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gen, reference as R

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def linear_score(score: dict) -> dict:
    """The configuration's linear-gap scores as reference.py's dict: a
    gap of l bases costs ge * l."""
    if score["gi"] != 0:
        raise ValueError("the linear model has no gap-open cost")
    return {"matrix": list(score["matrix"]), "gi": 0, "ge": score["ge"],
            "gf": score["ge"]}


def read_map(pool, i: int) -> np.ndarray:
    """(length + 1,) int64: entry k is the offset, in the forward
    (genome-strand) copy of read i, of the first base that source base k
    or a later one put there; entry `length` is that copy's length."""
    n = int(pool.length[i])
    err = 1.0 - float(pool.acc[i])
    split = pool.split
    r = gen._rng(pool.seed, 2, i).random(n)
    ps = err * split[0]
    pd = ps + err * split[2]
    counts = np.ones(n, np.int64)
    counts[(r >= ps) & (r < pd)] = 0
    counts[(r >= pd) & (r < err)] = 2
    return np.concatenate([[0], np.cumsum(counts)])


def read_interval(pool, i: int, a: int, b: int, pmap=None) -> tuple:
    """Read i's coordinates (as written) of genome interval [a, b)."""
    pm = read_map(pool, i) if pmap is None else pmap
    st = int(pool.start[i])
    lo, hi = int(pm[a - st]), int(pm[b - st])
    if pool.rev[i]:
        L = int(pm[-1])
        lo, hi = L - hi, L - lo
    return lo, hi


def overlapping(pool, i: int) -> np.ndarray:
    """Indices of the reads whose genome interval intersects read i's
    (read i itself included)."""
    st, ln = pool.start, pool.length
    return np.flatnonzero((st < st[i] + ln[i]) & (st[i] < st + ln))


def true_overlaps(pool, i: int, maps: dict | None = None) -> list:
    """One dict a read j != i that truly overlaps read i: j, the genome
    intersection's length `glen`, the strand, and the intersection in
    PAF coordinates (qs, qe on read i in strand space; ts, te on read
    j)."""
    maps = {} if maps is None else maps

    def pm(x):
        if x not in maps:
            maps[x] = read_map(pool, x)
        return maps[x]
    out = []
    qlen = int(pm(i)[-1])
    for j in overlapping(pool, i).tolist():
        if j == i:
            continue
        a = max(int(pool.start[i]), int(pool.start[j]))
        b = min(int(pool.start[i] + pool.length[i]),
                int(pool.start[j] + pool.length[j]))
        qs, qe = read_interval(pool, i, a, b, pm(i))
        ts, te = read_interval(pool, j, a, b, pm(j))
        strand = "+" if bool(pool.rev[i]) == bool(pool.rev[j]) else "-"
        if strand == "-":
            qs, qe = qlen - qe, qlen - qs
        out.append({"j": j, "glen": b - a, "strand": strand, "qs": qs,
                    "qe": qe, "ts": ts, "te": te})
    return out


def project(pool, i: int, j: int, strand: str, q: int,
            maps: dict) -> int:
    """Read j's coordinate (as written) of the genome position that lies
    at read i's PAF query coordinate q (strand space, a boundary between
    bases) for an alignment on `strand`: where the true alignment of the
    two reads puts q's partner. A position outside read j's interval is
    taken at its nearer end."""
    for x in (i, j):
        if x not in maps:
            maps[x] = read_map(pool, x)
    pi, pj = maps[i], maps[j]
    L = int(pi[-1])
    w = L - q if strand == "-" else q                     # as written
    fwd = L - w if pool.rev[i] else w
    g = int(pool.start[i]) + int(np.searchsorted(pi, fwd))
    k = min(max(g - int(pool.start[j]), 0), len(pj) - 1)
    t = int(pj[k])
    return int(pj[-1]) - t if pool.rev[j] else t


def strand_seq(codes: np.ndarray, strand: str) -> np.ndarray:
    """The query as the alignment reads it: reverse-complemented on
    '-'."""
    c = np.asarray(codes, np.int8)
    return (3 - c[::-1]) if strand == "-" else c


def sketch(codes: np.ndarray, k: int, w: int) -> set:
    """A read's (hash, pos, strand) minimizers (reference.sketch)."""
    h, pos, strand = R.sketch(codes, k, w)
    return set(zip(h.tolist(), pos.tolist(), strand.tolist()))
