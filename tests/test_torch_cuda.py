"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; skipped where torch.cuda.is_available() is false).
Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda

Fill results and walks must be identical; trace buffers over the
blocks each problem filled itself (the kernel stops a problem at its own
termination, the batched plain fill keeps stepping it)."""

import io
import os
import sys

import numpy as np
import pytest
import torch

from minialign_tpu.params import MapParams, ScoreParams
from minialign_tpu_torch import _build
from minialign_tpu_torch.dp import band, cuda_fill, cuda_gather, dtrace

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(__file__), "data")
PARAMS = {
    "affine": MapParams().score,
    "combined": ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                         for i in range(16)),
                            gi=4, ge=2, gfa=3, gfb=3, xdrop=50),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pairs(seed, B, lo, hi, dev):
    rng = np.random.default_rng(seed)
    a = [rng.integers(0, 4, int(rng.integers(lo, hi))) for _ in range(B)]
    b = []
    for s in a:
        r = rng.random(len(s))
        t = np.where(r < 0.05, rng.integers(0, 4, len(s)), s)
        reps = np.where(r > 0.96, 2, np.where((r > 0.05) & (r < 0.09), 0, 1))
        b.append(np.repeat(t, reps))
    ab, alen = band.pad_codes(a)
    bb, blen = band.pad_codes(b)
    return [torch.from_numpy(x).to(dev) for x in (ab, alen, bb, blen)]


def assert_fill_equal(rk, bk, rp, bp):
    for f in ("max_score", "max_i", "max_j", "n_steps", "n_blocks"):
        assert torch.equal(getattr(rk, f), getattr(rp, f)), f
    if bk is None:
        return
    own = (rk.n_steps // band.BLK).tolist()
    for f in ("masks", "dirs", "iheads", "rprevs"):
        xk, xp = getattr(bk, f), getattr(bp, f)
        for k, n in enumerate(own):
            assert torch.equal(xk[k, :n], xp[k, :n]), (f, k)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("W", [16, 32, 64])
@pytest.mark.parametrize("pname", ["affine", "combined"])
def test_fill_kernel_matches_plain(pname, W, trace, dev):
    p = PARAMS[pname]
    args = _pairs(W, 8, 100, 600, dev)
    nb = band.max_blocks_for(args[1].cpu().numpy(), args[3].cpu().numpy())
    got = cuda_fill.fill_cuda(p, W, nb, trace, *args)
    want = band.fill_plain(p, W, nb, trace, *args)
    if trace:
        assert_fill_equal(got[0], got[1], want[0], want[1])
    else:
        assert_fill_equal(got, None, want, None)


@pytest.mark.parametrize("W", [16, 32, 64])
@pytest.mark.parametrize("pname", ["affine", "combined"])
def test_dtrace_kernel_matches_plain(pname, W, dev):
    p = PARAMS[pname]
    args = _pairs(100 + W, 8, 100, 600, dev)
    nb = band.max_blocks_for(args[1].cpu().numpy(), args[3].cpu().numpy())
    res, bufs = cuda_fill.fill_cuda(p, W, nb, True, *args)
    walk = (bufs.masks, bufs.dirs, bufs.iheads, res.max_score, res.max_i,
            res.max_j)
    rk, sk = dtrace.dtrace(p, W, *walk)
    rp, sp = dtrace.dtrace_plain(p, W, *walk)
    assert torch.equal(sk, sp)
    assert torch.equal(rk, rp)


@pytest.mark.parametrize("wrap", [False, True])
def test_gather_kernel_matches_plain(wrap, dev):
    rng = np.random.default_rng(3)
    store = torch.from_numpy(rng.integers(0, 5, 50000).astype(np.int8)).to(dev)
    B, L = 64, 4096
    base = rng.integers(0, 2, B) * 25000
    seglen = np.full(B, 25000)
    start = rng.integers(0, 25100, B)
    start[:3] = [0, 24990, 25000]
    cap = rng.integers(0, L + 100, B)
    cap[3] = 0
    wr = seglen if wrap else np.zeros(B, np.int64)
    got = cuda_gather.gather(store, base, start, cap, seglen, wr, L)
    want = cuda_gather.gather_plain(store, base, start, cap, seglen, wr, L)
    assert torch.equal(got, want)


def test_cli_golden_on_cuda(dev, monkeypatch):
    """ref_out.sam through the port's CLI on the card, every kernel
    launched."""
    from minialign_tpu_torch import cli
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cuda")
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    _build.reset_counts()
    assert cli.main(["-t1", f"{DATA}/tref.fa", f"{DATA}/treads.fq"]) == 0
    assert all(n > 0 for n in _build.LAUNCHES.values()), _build.LAUNCHES
    with open(f"{DATA}/ref_out.sam") as f:
        want = [x for x in f.read().splitlines() if not x.startswith("@PG")]
    assert [x for x in out.getvalue().splitlines()
            if not x.startswith("@PG")] == want
