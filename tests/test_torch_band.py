"""Port fill (minialign_tpu_torch.dp.band.fill_plain) against the JAX
fill (minialign_tpu.dp.band.make_fill) and the Pallas kernel in
interpret mode: identical FillResult and TraceBuffers, exact (int32).
Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

from minialign_tpu.dp import band as jband
from minialign_tpu.dp import pallas_fill
from minialign_tpu.params import ScoreParams
from minialign_tpu_torch.dp import band as tband
from minialign_tpu_torch.params import from_fields

PARAMS = {
    "affine": ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -3
                                       for i in range(16)),
                          gi=5, ge=1, xdrop=80),
    "combined": ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                         for i in range(16)),
                            gi=4, ge=2, gfa=3, gfb=3, xdrop=60),
}


def mutate(rng, a, err=0.12):
    """~err edits: 40% substitutions, 30% deletions, 30% insertions."""
    out = []
    for ch in a:
        r = rng.random()
        if r < 0.4 * err:
            out.append(int(rng.integers(0, 4)))
        elif r < 0.7 * err:
            pass
        elif r < err:
            out += [int(ch), int(rng.integers(0, 4))]
        else:
            out.append(int(ch))
    return np.asarray(out, np.int64)


def make_pairs(seed, B, lo, hi):
    rng = np.random.default_rng(seed)
    seqs_a = [rng.integers(0, 4, int(rng.integers(lo, hi)))
              for _ in range(B)]
    seqs_b = [mutate(rng, a) for a in seqs_a]
    return seqs_a, seqs_b


def run_both(p, W, nb, trace, seqs_a, seqs_b):
    ab, alen = jband.pad_codes(seqs_a)
    bb, blen = jband.pad_codes(seqs_b)
    want = jband.make_fill(p, W, max_blocks=nb, trace=trace)(
        ab, alen, bb, blen)
    got = tband.fill_plain(from_fields(p), W, nb, trace, torch.from_numpy(ab),
                           torch.from_numpy(alen), torch.from_numpy(bb),
                           torch.from_numpy(blen))
    return want, got


def assert_same(want, got, trace):
    if trace:
        (rw, bw), (rg, bg) = want, got
    else:
        rw, rg = want, got
    for f in ("max_score", "max_i", "max_j", "n_steps", "n_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(rw, f)),
                                      getattr(rg, f).numpy(), err_msg=f)
    if trace:
        for f in ("masks", "dirs", "iheads", "rprevs"):
            w = np.asarray(getattr(bw, f))
            np.testing.assert_array_equal(
                w, getattr(bg, f).numpy().view(w.dtype), err_msg=f)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("W", [16, 32, 64])
@pytest.mark.parametrize("pname", ["affine", "combined"])
def test_fill_plain_matches_jax(pname, W, trace):
    seqs_a, seqs_b = make_pairs(11 + W, 6, 30, 220)
    want, got = run_both(PARAMS[pname], W, 24, trace, seqs_a, seqs_b)
    assert_same(want, got, trace)


@pytest.mark.parametrize("pname", ["affine", "combined"])
def test_fill_plain_empty_and_mismatch(pname):
    """Empty inputs and all-mismatch pairs (nothing to extend: the fill
    must stop at the X-drop or the p-limit with score 0)."""
    seqs_a = [np.zeros(0, np.int64), np.zeros(120, np.int64),
              np.zeros(0, np.int64), np.full(80, 2, np.int64)]
    seqs_b = [np.zeros(0, np.int64), np.full(120, 1, np.int64),
              np.full(40, 3, np.int64), np.zeros(0, np.int64)]
    want, got = run_both(PARAMS[pname], 32, 16, True, seqs_a, seqs_b)
    assert_same(want, got, True)
    assert (got[0].max_score.numpy() == 0).all()


def test_fill_plain_matches_pallas_interpret():
    """The Pallas kernel in interpret mode (as tests/test_pallas_fill.py
    runs it) against the port: scores, positions and trace over the
    blocks both filled."""
    p = PARAMS["affine"]
    W, nb = 64, 24
    seqs_a, seqs_b = make_pairs(5, 4, 40, 200)
    ab, alen = jband.pad_codes(seqs_a)
    bb, blen = jband.pad_codes(seqs_b)
    r1, b1 = pallas_fill.make_fill_pallas(p, W, max_blocks=nb, trace=True,
                                          interpret=True)(ab, alen, bb, blen)
    r2, b2 = tband.fill_plain(from_fields(p), W, nb, True,
                              torch.from_numpy(ab), torch.from_numpy(alen),
                              torch.from_numpy(bb), torch.from_numpy(blen))
    for f in ("max_score", "max_i", "max_j"):
        np.testing.assert_array_equal(np.asarray(getattr(r1, f)),
                                      getattr(r2, f).numpy())
    n = int(r2.n_blocks)
    assert int(np.asarray(r1.n_blocks)) >= n
    np.testing.assert_array_equal(np.asarray(b1.masks)[:, :n],
                                  b2.masks.numpy()[:, :n].view(np.uint32))
    np.testing.assert_array_equal(np.asarray(b1.dirs)[:, :n],
                                  b2.dirs.numpy()[:, :n].view(np.uint32))


def test_fill_dispatch_cpu_and_max_blocks():
    """band.fill on CPU tensors is fill_plain; max_blocks_for's budget
    gives the same results as a generous one."""
    p = from_fields(PARAMS["combined"])
    seqs_a, seqs_b = make_pairs(3, 5, 50, 150)
    ab, alen = jband.pad_codes(seqs_a)
    bb, blen = jband.pad_codes(seqs_b)
    args = (torch.from_numpy(ab), torch.from_numpy(alen),
            torch.from_numpy(bb), torch.from_numpy(blen))
    nb = tband.max_blocks_for(alen, blen)
    r1 = tband.fill(p, 32, nb, False, *args)
    r2 = tband.fill_plain(p, 32, 64, False, *args)
    for f in ("max_score", "max_i", "max_j", "n_steps"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f
