"""Port traceback walk (minialign_tpu_torch.dp.dtrace.dtrace_plain)
against the JAX device walker (make_device_traceback) and the host
walker (traceback_one), in the pattern of tests/test_dtrace.py: equal
decoded paths, counters, penalties and out-of-band statuses. The JAX
walker chunks runs differently, so n_ent and t_fin are compared with
the port's own canonical entries instead."""

import numpy as np
import pytest
import torch

from minialign_tpu.dp import band as jband
from minialign_tpu.dp import dtrace as jdtrace
from minialign_tpu.dp import traceback as jtraceback
from minialign_tpu.params import ScoreParams
from minialign_tpu_torch.dp import dtrace as tdtrace
from minialign_tpu_torch.extend import rle_paths_py
from minialign_tpu_torch.params import from_fields

PARAMS = {
    "affine": ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -3
                                       for i in range(16)),
                          gi=4, ge=1, xdrop=60),
    "combined": ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                         for i in range(16)),
                            gi=4, ge=2, gfa=3, gfb=3, xdrop=60),
}


def _fill(p, W, seed, B=16):
    rng = np.random.default_rng(seed)
    seqs_a, seqs_b = [], []
    for _ in range(B):
        L = int(rng.integers(40, 400))
        a = rng.integers(0, 4, L)
        b = a.copy()
        mut = rng.random(L) < 0.15
        b[mut] = rng.integers(0, 4, int(mut.sum()))
        for _ in range(int(rng.integers(0, 3))):
            pos = int(rng.integers(0, len(b)))
            b = np.concatenate([b[:pos], rng.integers(0, 4, 5), b[pos:]])
        seqs_a.append(a)
        seqs_b.append(b)
    ab, alen = jband.pad_codes(seqs_a)
    bb, blen = jband.pad_codes(seqs_b)
    res, bufs = jband.make_fill(p, W, max_blocks=40, trace=True)(
        ab, alen, bb, blen)
    res = type(res)(*(np.asarray(x) for x in res))
    bufs = type(bufs)(*(np.asarray(x) for x in bufs))
    return res, bufs


def _canonical(path_rev_ops):
    """Backward op codes -> maximal runs split every 63 (the port's
    entry form)."""
    ents = []
    for op in path_rev_ops:
        if ents and ents[-1][0] == op and ents[-1][1] < 63:
            ents[-1][1] += 1
        else:
            ents.append([op, 1])
    return [op | (n << 2) for op, n in ents]


@pytest.mark.parametrize("W", [16, 32, 64])
@pytest.mark.parametrize("pname", ["affine", "combined"])
def test_dtrace_plain_matches_jax(pname, W):
    p = PARAMS[pname]
    res, bufs = _fill(p, W, 23 + W)
    B = res.max_score.shape[0]
    rle, summ = tdtrace.dtrace_plain(
        from_fields(p), W, *(torch.from_numpy(np.array(x).view(np.int32))
                for x in (bufs.masks, bufs.dirs, bufs.iheads)),
        *(torch.from_numpy(np.array(x)) for x in (res.max_score, res.max_i,
                                        res.max_j)))
    rle, summ = rle.numpy(), summ.numpy()
    row = dict(zip(tdtrace.SUMMARY_ROWS, summ))

    _, _, jsum = jdtrace.make_device_traceback(p, W)(
        bufs.masks, bufs.dirs, bufs.iheads, res.max_score, res.max_i,
        res.max_j)
    jrow = dict(zip(jdtrace.SUMMARY_ROWS, np.asarray(jsum)))
    for k in ("n_ops", "bad", "score", "ai", "bj"):
        np.testing.assert_array_equal(row[k], jrow[k], err_msg=k)
    assert (row["t_fin"] == row["n_ent"].max()).all()

    n_traced = 0
    for k in range(B):
        want = jtraceback.traceback_one(
            p, W, bufs.masks[k], bufs.dirs[k], bufs.iheads[k],
            int(res.max_score[k]), int(res.max_i[k]), int(res.max_j[k]))
        if want is None:
            assert row["bad"][k] == 1, k
            continue
        assert row["bad"][k] == 0, k
        for c in ("dcnt", "agcnt", "bgcnt", "n_open", "n_ext", "gf_pen",
                  "e_pen"):
            assert row[c][k] == jrow[c][k], (c, k)
        ent = rle[k, :row["n_ent"][k]]
        path, path_rev, ops_rev = rle_paths_py(ent)
        assert path == want.path, k
        assert path_rev == want.path_rev, k
        assert ops_rev == want.ops_rev, k
        assert int((ent >> 2).sum()) == row["n_ops"][k], k
        assert list(ent) == _canonical(
            [{"D": 1, "R": 2, "X": 3}[c] for c in ops_rev]), k
        assert row["dcnt"][k] == want.dcnt, k
        assert row["agcnt"][k] == want.agcnt, k
        assert row["bgcnt"][k] == want.bgcnt, k
        gp = row["n_open"][k] * p.gi + row["n_ext"][k] * p.ge \
            + row["gf_pen"][k]
        assert gp == want.gap_penalty, k
        assert jtraceback._identity(p, int(res.max_score[k]),
                                    int(row["dcnt"][k]),
                                    int(row["e_pen"][k])) == want.identity
        n_traced += 1
    assert n_traced >= B // 2


def test_dtrace_plain_empty_and_bad():
    """Score-0 problems walk nothing; a max outside the band is 'bad'."""
    p = PARAMS["affine"]
    W = 32
    res, bufs = _fill(p, W, 5, B=4)
    score = torch.from_numpy(res.max_score.copy())
    ai = torch.from_numpy(res.max_i.copy())
    bj = torch.from_numpy(res.max_j.copy())
    score[0] = 0
    ai[1] = bj[1] + 3 * W          # far off the band's diagonal
    bj[1] = max(int(bj[1]), 1)
    rle, summ = tdtrace.dtrace_plain(
        from_fields(p), W, *(torch.from_numpy(np.array(x).view(np.int32))
                for x in (bufs.masks, bufs.dirs, bufs.iheads)),
        score, ai, bj)
    row = dict(zip(tdtrace.SUMMARY_ROWS, summ.numpy()))
    assert row["n_ent"][0] == 0 and row["bad"][0] == 0
    assert row["bad"][1] == 1
    assert row["bad"][2] == 0 and row["n_ops"][2] > 0
