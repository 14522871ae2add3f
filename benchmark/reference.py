"""The plain reference: minimap-style minimizers and Gotoh alignment
scores, written from minialign's published semantics in NumPy and
plain PyTorch. It imports nothing of the program under test and takes
nothing it made: every number here is worked out again from the
generated genome and reads.

- `sketch`: the (w, k) minimizers of a sequence as minialign defines
  them (minialign.c:2349-2448): canonical 2-bit k-mers, the hash
  CRC32-C(kx) ^ km over 2k bits, the value hash << 8 | pos mod w |
  strand << 7, a sliding minimum over w values with ties to the newest,
  emitted when the minimum changes or the newest value equals it.
- `path_score`: the score of an alignment given as a CIGAR, under the
  configuration's scores: a substitution matrix, and a gap of l bases
  costing min(gi + ge * l, gf * l) (gaba's combined model).
- `band_dp`: the best global score between two sequences within a band
  about the line from corner to corner, many problems at once, one row
  of the query a step, in int32, or in saturating int16 for the
  control; optionally with the moves for a traceback (`traceback`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

# ---------------------------------------------------------------------------
# minimizers
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78


def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> np.uint32(1)) ^ np.uint32(_POLY),
                     t >> np.uint32(1)).astype(np.uint32)
    return t


_CRC = _crc_table()


def _crc32c_self(x: np.ndarray) -> np.ndarray:
    """CRC32-C with the accumulator set to the low 32 bits of x, over
    the 8 bytes of x, lowest first (SSE4.2's crc32 on a 64-bit word)."""
    x = x.astype(np.uint64)
    acc = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    for i in range(8):
        byte = ((x >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint32)
        acc = (acc >> np.uint32(8)) ^ _CRC[(acc ^ byte) & np.uint32(0xFF)]
    return acc.astype(np.uint64)


def sketch(codes: np.ndarray, k: int, w: int):
    """(hash, pos, strand) of every minimizer emitted over `codes`, in
    order of emission; pos is the k-mer's first base."""
    c = np.asarray(codes, np.uint64) & np.uint64(3)
    n = len(c) - k + 1
    if n <= 0:
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(0, np.uint8))
    fw = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    for j in range(k):
        fw = (fw << np.uint64(2)) | c[j:j + n]
        rc = rc | ((np.uint64(3) - c[j:j + n]) << np.uint64(2 * j))
    strand = rc <= fw
    km = np.where(strand, rc, fw)
    kx = np.where(strand, fw, rc)
    mask = np.uint64((1 << (2 * k)) - 1)
    h = (_crc32c_self(kx) ^ km) & mask
    idx = np.arange(n, dtype=np.uint64) % np.uint64(w)
    v = (h << np.uint64(8)) | idx | (strand.astype(np.uint64) << np.uint64(7))
    big = np.full(w - 1, np.iinfo(np.uint64).max, np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([big, v]), w)
    # newest position among equal minima
    back = np.argmin(win[:, ::-1], axis=1)
    vmin = win[np.arange(n), w - 1 - back]
    at = np.arange(n) - back
    prev = np.concatenate([[np.uint64(0)], vmin[:-1]])
    emit = (vmin != prev) | (vmin == v)
    at = np.where(vmin == v, np.arange(n), at)
    return ((vmin[emit] >> np.uint64(8)), at[emit].astype(np.int64),
            ((vmin[emit] >> np.uint64(7)) & np.uint64(1)).astype(np.uint8))


def sketch_region(codes: np.ndarray, k: int, w: int, lo: int, hi: int):
    """The minimizers of the whole sequence whose pos lies in [lo, hi),
    worked out from a slice that starts early enough for the sliding
    window to hold what it holds over the whole sequence."""
    s = max(0, lo - 2 * (w + k))
    e = min(len(codes), hi + k + w)
    h, pos, strand = sketch(codes[s:e], k, w)
    pos = pos + s
    keep = (pos >= lo) & (pos < hi)
    return h[keep], pos[keep], strand[keep]


# ---------------------------------------------------------------------------
# alignment scores
# ---------------------------------------------------------------------------

_CIG = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar: str) -> list:
    ops = [(int(n), op) for n, op in _CIG.findall(cigar)]
    if "".join(f"{n}{op}" for n, op in ops) != cigar:
        raise ValueError(f"bad CIGAR {cigar[:40]!r}")
    return ops


def gap_cost(score: dict, length):
    length = np.asarray(length, np.int64)
    return np.minimum(score["gi"] + score["ge"] * length,
                      score["gf"] * length)


def columns(ops: list):
    """The aligned part of a CIGAR (clips dropped) as per-column arrays:
    op code (0 M, 1 I, 2 D), and the ref and query offsets before the
    column."""
    kinds = {"M": 0, "=": 0, "X": 0, "I": 1, "D": 2}
    core = [(n, kinds[op]) for n, op in ops if op in kinds]
    if not core:
        return (np.zeros(0, np.int8),) + (np.zeros(1, np.int64),) * 2
    n = np.asarray([c[0] for c in core], np.int64)
    k = np.repeat(np.asarray([c[1] for c in core], np.int8), n)
    r = np.concatenate([[0], np.cumsum(k != 1)])
    q = np.concatenate([[0], np.cumsum(k != 2)])
    return k, r, q


def path_score(score: dict, kinds: np.ndarray, ref: np.ndarray,
               qry: np.ndarray, r: np.ndarray, q: np.ndarray) -> int:
    """Score of columns [0, len(kinds)) of a path; ref and qry start at
    the path's first column; r, q are the offsets before each column."""
    m = kinds == 0
    mat = np.asarray(score["matrix"], np.int64).reshape(4, 4)
    s = int(mat[qry[q[:-1][m]], ref[r[:-1][m]]].sum())
    if len(kinds):
        edge = np.flatnonzero(np.diff(np.concatenate(
            [[-1], kinds.astype(np.int64), [-1]])) != 0)
        run_k = kinds[edge[:-1]]
        run_n = np.diff(edge)
        s -= int(gap_cost(score, run_n[run_k != 0]).sum())
    return s


# ---------------------------------------------------------------------------
# banded global DP
# ---------------------------------------------------------------------------

NEG = -(1 << 28)
# move codes of `band_dp(..., moves=True)`, one byte a cell: bits 0-1,
# where the cell's best score without a horizontal gap came from (0 the
# diagonal, 1 the affine vertical gap, 2 the linear one); bits 2-3, where
# its score came from (0 that, 1 the affine horizontal gap, 2 the linear
# one); bits 4-7, whether the affine and linear vertical and the affine
# and linear horizontal gap states extended (1) or opened (0) there
H_, H0_, FA, FL, EA, EL = range(6)


def band_dp(score: dict, refs: list, qrys: list, half: int,
            device="cpu", int16: bool = False, moves: bool = False):
    """Best global scores of problems (refs[p], qrys[p]) over the cells
    whose ref offset lies within `half` of round(i * m / n) in query row
    i. Returns (P,) int64 scores and, with moves, a (P, n+1, 2*half+1)
    uint8 tensor of move codes. int16: every stored value saturates at
    the int16 range, as 16-bit SIMD alignment arithmetic does."""
    P = len(refs)
    B = 2 * half + 1
    dev = torch.device(device)
    m = torch.as_tensor([len(x) for x in refs], dtype=torch.int64,
                        device=dev)
    n = torch.as_tensor([len(x) for x in qrys], dtype=torch.int64,
                        device=dev)
    N = int(n.max()) if P else 0
    LR = int(m.max()) if P else 0
    R = torch.full((P, LR + 2 * B + 2), 4, dtype=torch.int64, device=dev)
    Q = torch.full((P, N + 1), 4, dtype=torch.int64, device=dev)
    for p in range(P):
        R[p, B + 1:B + 1 + len(refs[p])] = torch.as_tensor(
            np.asarray(refs[p], np.int64), device=dev)
        Q[p, :len(qrys[p])] = torch.as_tensor(
            np.asarray(qrys[p], np.int64), device=dev)
    mat = torch.full((5, 5), NEG, dtype=torch.int64, device=dev)
    mat[:4, :4] = torch.as_tensor(np.asarray(score["matrix"]).reshape(4, 4),
                                  device=dev)
    gi, ge, gf = score["gi"], score["ge"], score["gf"]
    lo_c, hi_c = (-32768, 32767) if int16 else (NEG, -NEG)

    def sat(x):
        return x.clamp(lo_c, hi_c)

    d = torch.arange(-half, half + 1, device=dev)
    nn = n.clamp(min=1)

    def center(i):
        return torch.div(i * m * 2 + nn, 2 * nn, rounding_mode="floor")

    def gap(L):
        return torch.minimum(gi + ge * L, gf * L)

    # row 0: a leading deletion of j bases
    j = center(torch.zeros_like(n))[:, None] + d[None, :]
    inb = (j >= 0) & (j <= m[:, None])
    H = torch.where(inb, sat(-gap(j.clamp(min=0)) * (j > 0)), NEG)
    Fa = torch.full_like(H, NEG)
    Fl = torch.full_like(H, NEG)
    mv = (torch.zeros((P, N + 1, B), dtype=torch.uint8, device=dev)
          if moves else None)
    cprev = center(torch.zeros_like(n))
    idx = torch.arange(B, device=dev)
    for i in range(1, N + 1):
        live = (i <= n)[:, None]
        ii = torch.full_like(n, i)
        c = center(ii)
        sh = (c - cprev)[:, None]
        j = c[:, None] + d[None, :]
        inb = (j >= 0) & (j <= m[:, None]) & live

        def from_prev(t, off):
            k = idx[None, :] + sh + off
            ok = (k >= 0) & (k < B)
            return torch.where(ok, t.gather(1, k.clamp(0, B - 1)), NEG)
        Hup = from_prev(H, 0)
        Hdg = from_prev(H, -1)
        q = Q[:, i - 1][:, None]
        r = R.gather(1, (j + B).clamp(0, R.shape[1] - 1))
        s = mat[q.expand_as(r), r]
        diag = torch.where(j >= 1, sat(Hdg + s), NEG)
        fa_ext = sat(from_prev(Fa, 0) - ge)
        fa_opn = sat(Hup - gi - ge)
        Fa_n = torch.maximum(fa_ext, fa_opn)
        fl_ext = sat(from_prev(Fl, 0) - gf)
        fl_opn = sat(Hup - gf)
        Fl_n = torch.maximum(fl_ext, fl_opn)
        H0 = torch.maximum(diag, torch.maximum(Fa_n, Fl_n))
        # horizontal gaps: best of H0 at k < j, priced from k
        ea = torch.cummax(H0 + ge * d, 1).values
        ea = torch.cat([torch.full_like(ea[:, :1], NEG), ea[:, :-1]], 1)
        Ea = sat(ea - gi - ge * d)
        el = torch.cummax(H0 + gf * d, 1).values
        el = torch.cat([torch.full_like(el[:, :1], NEG), el[:, :-1]], 1)
        El = sat(el - gf * d)
        Hn = torch.maximum(H0, torch.maximum(Ea, El))
        # column 0: a leading insertion of i bases
        Hn = torch.where(j == 0, sat(-gap(ii)[:, None]).expand_as(Hn), Hn)
        if moves:
            src0 = torch.where(H0 == diag, 0, torch.where(H0 == Fa_n, 1, 2))
            src = torch.where(Hn == H0, 0, torch.where(Hn == Ea, 1, 2))
            H0p = torch.cat([torch.full_like(H0[:, :1], NEG), H0[:, :-1]], 1)
            Eap = torch.cat([torch.full_like(Ea[:, :1], NEG), Ea[:, :-1]], 1)
            Elp = torch.cat([torch.full_like(El[:, :1], NEG), El[:, :-1]], 1)
            code = (src0 | (src << 2)
                    | ((fa_ext > fa_opn).long() << 4)
                    | ((fl_ext > fl_opn).long() << 5)
                    | ((sat(Eap - ge) > sat(H0p - gi - ge)).long() << 6)
                    | ((sat(Elp - gf) > sat(H0p - gf)).long() << 7))
            mv[:, i] = torch.where(inb, code, 0).to(torch.uint8)
        H = torch.where(live, torch.where(inb, Hn, NEG), H)
        Fa = torch.where(live, torch.where(inb, Fa_n, NEG), Fa)
        Fl = torch.where(live, torch.where(inb, Fl_n, NEG), Fl)
        cprev = torch.where(i <= n, c, cprev)
    end = (m - cprev + half).clamp(0, B - 1)
    out = H.gather(1, end[:, None])[:, 0]
    return out.cpu().numpy().astype(np.int64), mv


def traceback(mv: np.ndarray, m: int, n: int, half: int) -> str:
    """The CIGAR of the path that `band_dp`'s moves for one problem
    ((n+1, 2*half+1) uint8) give from (n, m) back to (0, 0)."""
    nn = max(n, 1)
    ops = []
    i, j, state = n, m, H_
    while i > 0 or j > 0:
        if i == 0 or j == 0:
            ops.append("D" if i == 0 else "I")
            i, j = (i, j - 1) if i == 0 else (i - 1, j)
            continue
        k = j - (i * m * 2 + nn) // (2 * nn) + half
        code = int(mv[i, k]) if 0 <= k < mv.shape[1] else 0
        if state == H_:
            state = (H0_, EA, EL)[(code >> 2) & 3]
        if state == H0_:
            state = (None, FA, FL)[code & 3]
            if state is None:
                ops.append("M")
                i, j, state = i - 1, j - 1, H_
                continue
        if state in (FA, FL):
            ops.append("I")
            ext = code >> (4 if state == FA else 5) & 1
            i -= 1
            state = state if ext else H_
        else:
            ops.append("D")
            ext = code >> (6 if state == EA else 7) & 1
            j -= 1
            state = state if ext else H0_
    ops.reverse()
    out = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1][0] += 1
        else:
            out.append([1, op])
    return "".join(f"{c}{op}" for c, op in out)
