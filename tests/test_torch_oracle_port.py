"""The port's fill and traceback held to the port's naive DP oracle
(minialign_tpu_torch/dp/oracle.py), as tests/test_oracle.py and
tests/test_band.py:79 hold the JAX ones: random pairs mutated within the
band under test_band.py's five score models at W 16/32/64, the fill and
traceback_batch against oracle_extend on score, max position and path,
and calc_score recomputing each traced score. Here the plain fill on the
CPU; tests/test_torch_cuda.py runs the same check with the fill kernel
on the card. No JAX here (the card's machine has none): the models and
the mutation are the port's own, which test_torch_oracle.py checks to be
test_band.py's."""

import zlib

import numpy as np
import pytest
import torch

from minialign_tpu_torch.dp import band as tband
from minialign_tpu_torch.dp import oracle as toracle
from minialign_tpu_torch.dp import traceback as ttraceback
from minialign_tpu_torch.params import ScoreParams


def simple(m, x, gi, ge, **kw):
    mat = tuple(m if (i & 3) == (i >> 2) else -x for i in range(16))
    return ScoreParams(matrix=mat, gi=gi, ge=ge, xdrop=80, **kw)


PORT_PARAMS = {
    "linear": simple(1, 2, 0, 1),
    "affine": simple(2, 3, 5, 1),
    "affine_default": simple(1, 1, 1, 1),
    "combined": simple(2, 3, 5, 1, gfa=2, gfb=2),
    "combined_pacbio": simple(2, 4, 4, 2, gfa=3, gfb=3),
}


def mutate(rng, a, wband):
    """Mutated copy of a with drift bounded to the band width (a copy of
    tests/test_band.py's)."""
    out = []
    drift = 0
    lim = wband // 2 - 6
    for ch in a:
        r = rng.random()
        if r < 0.10:
            out.append(rng.integers(0, 4))
        elif r < 0.15 and drift < lim:
            out.append(rng.integers(0, 4))
            out.append(ch)
            drift += 1
        elif r < 0.20 and drift > -lim:
            drift -= 1
        else:
            out.append(ch)
    return np.asarray(out, np.int64)


def port_fill(p, W, nb, a, b, device="cpu"):
    """The port's traced fill (the kernel on a CUDA device, fill_plain on
    the CPU) on numpy pairs, its results and buffers as numpy in the JAX
    types (the int32 words viewed as uint32), as traceback_batch takes
    them."""
    ab, alen = tband.pad_codes(a)
    bb, blen = tband.pad_codes(b)
    res, bufs = tband.fill(p, W, nb, True, *(
        torch.from_numpy(x).to(device) for x in (ab, alen, bb, blen)))
    res = type(res)(*(x.cpu().numpy() for x in res))
    masks, dirs, iheads, rprevs = (x.cpu().numpy() for x in bufs)
    return res, type(bufs)(masks.view(np.uint32), dirs.view(np.uint32),
                           iheads, rprevs)


def cross_check(pname, W, device="cpu", n_trials=16):
    """test_band.py:test_cross_band_vs_oracle on the port: the fill and
    traceback_batch against oracle_extend, score, max position and path
    (PORT_PARAMS' models, pairs mutated within the band)."""
    p = PORT_PARAMS[pname]
    rng = np.random.default_rng(zlib.crc32(f"port/{pname}/{W}".encode()))
    a, b, want = [], [], []
    for _ in range(n_trials):
        x = rng.integers(0, 4, int(rng.integers(10, 300)))
        y = mutate(rng, x, W)
        if len(y) == 0:
            y = np.asarray([x[0]], np.int64)
        a.append(x)
        b.append(y)
        want.append(toracle.oracle_extend(p, x, y))
    res, bufs = port_fill(p, W, 40, a, b, device)
    traces = ttraceback.traceback_batch(p, W, bufs, res)
    for k, e in enumerate(want):
        assert (int(res.max_score[k]), int(res.max_i[k]),
                int(res.max_j[k])) == (e.score, e.alen, e.blen), (pname, W, k)
        t = traces[k]
        assert t is not None, (pname, W, k)
        assert t.path == e.path, (pname, W, k)
        assert ttraceback.calc_score(p, t.path, a[k], b[k])["score"] == \
            e.score, (pname, W, k)


@pytest.mark.parametrize("W", (16, 32, 64))
@pytest.mark.parametrize("pname", sorted(PORT_PARAMS))
def test_port_plain_fill_and_traceback_match_port_oracle(pname, W):
    cross_check(pname, W)
