"""The plain reference against brute force: minimizers against a direct
reading of the definition, the band DP and its traceback against a full
Gotoh DP, and a CIGAR's score against a hand count."""

import numpy as np
import pytest

from benchmark import gen, reference as R

SC = {"matrix": [2, -4, -4, -4, -4, 2, -4, -4, -4, -4, 2, -4, -4, -4, -4, 2],
      "gi": 4, "ge": 2, "gf": 3}


def _brute_minimizers(codes, k, w):
    """Straight from the definition, one position at a time."""
    n = len(codes) - k + 1
    vals = []
    for i in range(n):
        fw = rc = 0
        for j in range(k):
            fw = (fw << 2) | int(codes[i + j])
            rc |= (3 - int(codes[i + j])) << (2 * j)
        strand = 1 if rc <= fw else 0
        km, kx = (rc, fw) if strand else (fw, rc)
        acc = kx & 0xFFFFFFFF
        for b in range(8):
            acc ^= (kx >> (8 * b)) & 0xFF
            for _ in range(8):
                acc = (acc >> 1) ^ (0x82F63B78 if acc & 1 else 0)
        h = (acc ^ km) & ((1 << (2 * k)) - 1)
        vals.append((h << 8) | (i % w) | (strand << 7))
    out, prev = [], 0
    for i in range(n):
        win = [(vals[j], j) for j in range(max(0, i - w + 1), i + 1)]
        pad = [(2**64 - 1, -1)] * (w - len(win))
        vmin = min(v for v, _ in pad + win)
        at = max(j for v, j in win if v == vmin) if vmin != 2**64 - 1 else -1
        if vmin != prev or vmin == vals[i]:
            out.append((vmin >> 8, i if vmin == vals[i] else at,
                        (vmin >> 7) & 1))
        prev = vmin
    return out


@pytest.mark.parametrize("k,w", [(15, 10), (5, 3), (4, 1)])
def test_sketch_matches_definition(k, w):
    c = np.random.default_rng(k * 7 + w).integers(0, 4, 600, dtype=np.int8)
    c[200:260] = c[100:160]                   # a repeat
    h, pos, strand = R.sketch(c, k, w)
    got = list(zip(h.tolist(), pos.tolist(), strand.tolist()))
    assert got == _brute_minimizers(c, k, w)
    lo, hi = 250, 400
    hr, pr, sr = R.sketch_region(c, k, w, lo, hi)
    keep = [t for t in got if lo <= t[1] < hi]
    assert list(zip(hr.tolist(), pr.tolist(), sr.tolist())) == keep


def _full_dp(a, b):
    m, n = len(a), len(b)
    mat = np.asarray(SC["matrix"]).reshape(4, 4)
    H = np.full((n + 1, m + 1), -10**9)
    H[0, 0] = 0

    def g(L):
        return min(SC["gi"] + SC["ge"] * L, SC["gf"] * L)
    for i in range(n + 1):
        for j in range(m + 1):
            if i == 0 and j == 0:
                continue
            best = -10**9
            if i and j:
                best = H[i - 1, j - 1] + mat[b[i - 1], a[j - 1]]
            for L in range(1, i + 1):
                best = max(best, H[i - L, j] - g(L))
            for L in range(1, j + 1):
                best = max(best, H[i, j - L] - g(L))
            H[i, j] = best
    return int(H[n, m])


def test_band_dp_and_traceback_against_full_dp():
    rng = np.random.default_rng(3)
    refs, qrys = [], []
    for _ in range(6):
        a = rng.integers(0, 4, int(rng.integers(15, 35)), dtype=np.int8)
        refs.append(a)
        qrys.append(gen.mutate(rng, a, 0.3, (0.4, 0.3, 0.3)))
    sc, mv = R.band_dp(SC, refs, qrys, half=40, moves=True)
    for p in range(6):
        assert sc[p] == _full_dp(refs[p], qrys[p])
        cig = R.traceback(mv[p].numpy(), len(refs[p]), len(qrys[p]), 40)
        k, r, q = R.columns(R.parse_cigar(cig))
        assert (r[-1], q[-1]) == (len(refs[p]), len(qrys[p]))
        assert R.path_score(SC, k, refs[p], qrys[p], r, q) == sc[p]
    # int16 agrees where nothing saturates
    sc16, _ = R.band_dp(SC, refs, qrys, half=40, int16=True)
    assert np.array_equal(sc16, sc)


def test_int16_saturates_on_a_long_exact_match():
    a = np.random.default_rng(1).integers(0, 4, 20000, dtype=np.int8)
    s32, _ = R.band_dp(SC, [a], [a], half=8)
    s16, _ = R.band_dp(SC, [a], [a], half=8, int16=True)
    assert s32[0] == 40000 and s16[0] == 32767


def test_path_score_hand_count():
    ref = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int8)
    qry = np.array([0, 1, 2, 0, 1, 2, 2, 3], np.int8)
    # 3M (3 matches) 1D (gap 1: 3) 3M (3 matches) 1I (gap 1: 3) 1M (match)
    k, r, q = R.columns(R.parse_cigar("3M1D3M1I1M"))
    assert R.path_score(SC, k, ref, qry, r, q) == 7 * 2 - 3 - 3
    k, r, q = R.columns(R.parse_cigar("2S2M5D"))
    assert (r[-1], q[-1]) == (7, 2)
    # qry[2:] = 2, 0 against ref 0, 1: two mismatches, then a 5-base gap
    assert R.path_score(SC, k, ref, qry[2:], r, q) == -4 - 4 - 14
    with pytest.raises(ValueError):
        R.parse_cigar("3M1Q")
