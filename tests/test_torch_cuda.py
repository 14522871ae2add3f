"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; skipped where torch.cuda.is_available() is false).
Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda

Fill results and walks must be identical; trace buffers over the
blocks each problem filled itself (the kernel stops a problem at its own
termination, the batched plain fill keeps stepping it). The step-mix
probes P1-P4 (minialign_tpu_torch.probes) must equal their plain twins
exactly, one dtype of each kind."""

import io
import os
import sys

import numpy as np
import pytest
import torch

from minialign_tpu_torch import _build
from minialign_tpu_torch.dp import band, cuda_fill, cuda_gather, dtrace
from minialign_tpu_torch.params import MapParams, ScoreParams
from minialign_tpu_torch.probes import bf16ops, lowprec, subint32, wordstream
from minialign_tpu_torch.probes._common import tensor

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


def _edge_args(dev):
    """chip_smoke.edge_pairs's problems: a tandem repeat against itself,
    b == a, an unrelated pair that X-drops at once, problems shorter
    than W, empty ones."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 7)
    rep = np.tile(unit, 60)
    same = rng.integers(0, 4, 500)
    short = rng.integers(0, 4, 20)
    empty = np.zeros(0, np.int64)
    a, b = zip((rep, np.tile(unit, 55)), (rep, rep.copy()),
               (same, same.copy()),
               (rng.integers(0, 4, 600), rng.integers(0, 4, 600)),
               (rng.integers(0, 4, 5), rng.integers(0, 4, 9)),
               (rng.integers(0, 4, 40), rng.integers(0, 4, 30)),
               (short, short.copy()), (empty, rng.integers(0, 4, 50)),
               (empty, empty))
    return [torch.from_numpy(x).to(dev)
            for x in (*band.pad_codes(a), *band.pad_codes(b))]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("W", [16, 32, 64])
@pytest.mark.parametrize("pname", ["affine", "combined"])
def test_fill_and_walk_kernels_on_edge_cases(pname, W, trace, dev):
    p = PARAMS[pname]
    args = _edge_args(dev)
    nb = band.max_blocks_for(args[1].cpu().numpy(), args[3].cpu().numpy())
    got = cuda_fill.fill_cuda(p, W, nb, trace, *args)
    want = band.fill_plain(p, W, nb, trace, *args)
    if not trace:
        assert_fill_equal(got, None, want, None)
        return
    assert_fill_equal(got[0], got[1], want[0], want[1])
    res, bufs = got
    walk = (bufs.masks, bufs.dirs, bufs.iheads, res.max_score, res.max_i,
            res.max_j)
    rk, sk = dtrace.dtrace(p, W, *walk)
    rp, sp = dtrace.dtrace_plain(p, W, *walk)
    assert torch.equal(sk, sp) and torch.equal(rk, rp)


@pytest.mark.parametrize("W", [16, 64])
def test_fill_and_walk_kernels_max_in_last_block(W, dev):
    """a == b with the block budget ending in the block of the max."""
    x = np.random.default_rng(9).integers(0, 4, 700)
    args = [torch.from_numpy(v).to(dev)
            for v in (*band.pad_codes([x]), *band.pad_codes([x]))]
    nb = (2 * len(x) - 2) // band.BLK + 1
    p = PARAMS["affine"]
    res, bufs = cuda_fill.fill_cuda(p, W, nb, True, *args)
    want = band.fill_plain(p, W, nb, True, *args)
    assert_fill_equal(res, bufs, *want)
    assert int(res.max_i[0]) == len(x)
    assert (int(res.max_i[0] + res.max_j[0]) - 2) // band.BLK == nb - 1
    walk = (bufs.masks, bufs.dirs, bufs.iheads, res.max_score, res.max_i,
            res.max_j)
    rk, sk = dtrace.dtrace(p, W, *walk)
    rp, sp = dtrace.dtrace_plain(p, W, *walk)
    assert torch.equal(sk, sp) and torch.equal(rk, rp)


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
    assert all(_build.LAUNCHES[k] > 0 for k in ("fill", "gather", "dtrace")), \
        _build.LAUNCHES
    with open(f"{DATA}/ref_out.sam") as f:
        want = [x for x in f.read().splitlines() if not x.startswith("@PG")]
    assert [x for x in out.getvalue().splitlines()
            if not x.startswith("@PG")] == want


# ---- the step-mix probes P1-P4


def _same(got, want):
    assert got.dtype == want.dtype and torch.equal(got, want), \
        (got - want).abs().max() if got.shape == want.shape else got.shape


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "uint8"])
def test_p1_kernel_matches_plain(dtype, carry, dev):
    rng = np.random.default_rng(11)
    for op in subint32.CARRY_OPS if carry else subint32.BINOPS:
        x, y = subint32.inputs(rng, dtype, dev, *subint32.RANGE)
        if carry:
            _same(subint32.probe_carry(op, x, y, dev),
                  subint32.probe_carry_plain(op, x, y))
        else:
            _same(subint32.probe(op, x, y, dev),
                  subint32.probe_plain(op, x, y))


@pytest.mark.parametrize("dtype", ["int16", "bfloat16", "float32"])
def test_p2_kernels_match_plain(dtype, dev):
    rng = np.random.default_rng(12)
    for op in lowprec.BINOPS:
        x, y = lowprec.inputs(rng, dtype, dev)
        _same(lowprec.elementwise(op, x, y, dev),
              lowprec.elementwise_plain(op, x, y))
    x, y = lowprec.inputs(rng, dtype, dev)
    _same(lowprec.in_carry("maximum", x, y, dev),
          lowprec.in_carry_plain("maximum", x, y))
    _same(lowprec.roll_concat(x, y, dev), lowprec.roll_concat_plain(x, y))
    for B in (128, 1024):
        x, dd = lowprec.step_inputs(rng, dtype, dev, B)
        for n in (1, 64, 300):
            _same(lowprec.step_loop(x, dd, n, dev),
                  lowprec.step_timer_plain(x, dd, n))


def test_p3_kernels_match_plain(dev):
    rng = np.random.default_rng(13)
    for op, _, dtype in bf16ops.OPS:
        x, y = bf16ops.inputs(rng, dtype, dev)
        _same(bf16ops.run2(op, x, y, dev), bf16ops.run2_plain(op, x, y))
    for dtype in ("int32", "bfloat16"):
        x = bf16ops.timing_input(rng, dtype, dev)
        for n in (1, 64):
            _same(bf16ops.timing_loop(x, n, dev), bf16ops.timing_plain(x, n))


def test_p4_kernels_match_plain(dev):
    rng = np.random.default_rng(14)
    shape = wordstream.SHAPE
    w = tensor(rng.integers(0, 2**30, shape), "int32", dev)
    s = tensor(rng.integers(0, 12, shape), "int32", dev)
    _same(wordstream.var_shift(w, s, dev), wordstream.var_shift_plain(w, s))
    _same(wordstream.roll_in_carry(w, dev), wordstream.roll_in_carry_plain(w))
    x = torch.arange(2**18, dtype=torch.int32, device=dev).reshape(-1, 128)
    _same(wordstream.div10_magic(x, dev), wordstream.div10_magic_plain(x))
    wb = tensor(rng.integers(0, 2**30, shape), "int32", dev)
    d = tensor(rng.integers(0, 7, (1, shape[1])), "int32", dev)
    for n in (1, 64, 300):
        _same(wordstream.stream_loop(w, wb, d, n, dev),
              wordstream.stream_timing_plain(w, wb, d, n))
