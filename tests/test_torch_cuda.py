"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; skipped where torch.cuda.is_available() is false),
the whole golden suite through the CLI on the card, and the duo against
the two-step path on the card.
Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda

Fill results and walks must be identical; trace buffers over the
blocks each problem filled itself (the kernel stops a problem at its own
termination, the batched plain fill keeps stepping it). The step-mix
probes P1-P4 (minialign_tpu_torch.probes) must equal their plain twins
exactly, one dtype of each kind."""

import dataclasses
import io
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from minialign_tpu_torch import _build, kbench
from minialign_tpu_torch.dp import band, cuda_fill, cuda_gather, dtrace, duo
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
    flat = rng.integers(0, 5, 50000).astype(np.int8)
    store = torch.from_numpy(cuda_gather.pad_store(flat)).to(dev)
    B, L = 64, 4096
    seglen = np.full(B, 25000)
    start = rng.integers(0, 25100, B)
    start[:3] = [0, 24990, 25000]
    cap = rng.integers(0, L + 100, B)
    cap[3] = 0
    side = dict(base=rng.integers(0, 2, B) * 25000, start=start, cap=cap,
                seglen=seglen, wrap=seglen if wrap else np.zeros(B, np.int64),
                elen=np.minimum(cap, L))
    blk = torch.from_numpy(cuda_gather.pack_desc([side])).to(dev)
    got = cuda_gather.gather_pair(store, store, blk, B, L, 0)
    want = cuda_gather.gather_pair_plain(store, store, blk, B, L, 0)
    assert torch.equal(got[0], want[0]) and got[1].shape == (0, 0)


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("L", [128, 4096, 32768])
def test_gather_pair_kernel_on_edge_cases(L, B, padded, dev):
    """Both sides in one launch, each from its own store and at its own
    L (side b at the next L of the list), rows cycling through every
    edge case of kbench.GATHER_KINDS; equal to the plain two-sided form.
    An unpadded store sends the vectors at its end down the byte path."""
    rng = np.random.default_rng(L + B)
    Ls = (128, 4096, 32768)
    Lb = Ls[(Ls.index(L) + 1) % len(Ls)]
    (fa, sa), (fb, sb) = (kbench.gather_side(rng, x, B) for x in (L, Lb))
    sta, stb = (torch.from_numpy(cuda_gather.pad_store(f) if padded else f)
                .to(dev) for f in (fa, fb))
    blk = torch.from_numpy(cuda_gather.pack_desc([sa, sb])).to(dev)
    _build.reset_counts()
    got = cuda_gather.gather_pair(sta, stb, blk, B, L, Lb)
    assert _build.LAUNCHES["gather"] == 1
    want = cuda_gather.gather_pair_plain(sta, stb, blk, B, L, Lb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", [g[0] for g in chip_smoke.GOLDENS])
def test_cli_golden_on_cuda(name, dev, monkeypatch, tmp_path):
    """Every golden through the port's CLI on the card with the duo on
    (the default), compared as tests/test_golden_sam.py compares it:
    the fill, gather and walk launched, one gather a fill, the duo
    kernel on a linear reference. A -tN case's worker processes log
    their launches (MINIALIGN_LAUNCH_LOG), which count too."""
    from minialign_tpu_torch import cli
    _, args, golden, mode, _, pre = {g[0]: g for g in chip_smoke.GOLDENS}[
        name]
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cuda")
    monkeypatch.delenv("MINIALIGN_DUO", raising=False)
    monkeypatch.delenv("MINIALIGN_PROC_WORKERS", raising=False)
    logs = tmp_path / "launches"
    logs.mkdir()

    def run(a):
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdout", out)
        assert cli.main(chip_smoke.golden_args(a, DATA, str(tmp_path))) == 0
        return out.getvalue()
    if pre:
        run(pre)
    _build.reset_counts()
    monkeypatch.setenv("MINIALIGN_LAUNCH_LOG", str(logs))
    got = run(args)
    workers = _build.worker_launches(str(logs))
    n = {k: v + workers[k] for k, v in _build.LAUNCHES.items()}
    assert all(n[k] > 0 for k in ("fill", "gather", "dtrace")), n
    assert n["gather"] == n["fill"]
    if not any(a.startswith("-c") for a in args):
        assert n["duo"] > 0, n
    with open(f"{DATA}/{golden}") as f:
        want = f.read()
    assert chip_smoke.golden_view(got, mode) == \
        chip_smoke.golden_view(want, mode)


# ---- D1: the duo


@pytest.mark.parametrize("B", [1, 48, 512])
def test_duo_window_kernel_matches_plain(B, dev):
    """The duo window in the untraced fill's epilogue, on
    kbench.duo_fill_case (failed downs, duo_geometry's edge geometry,
    reads and references past 262 kb), the geometry read from behind a
    down descriptor block as the engine uploads it, the down rows
    written into the rows of a summary buffer: the fill's results equal
    fill_plain's, the descriptor block and down rows duo_window_plain's
    on them; one fill launch, counted as one duo launch too."""
    ab, alen, bb, blen, c = kbench.duo_fill_case(band, B, B)
    g = duo.pack_geom(c["rvbase"], c["qub"], c["rlen"], c["qlen"], c["cp0"],
                      c["cp1"])
    blk = torch.from_numpy(np.concatenate(
        [np.full(cuda_gather.WORDS * 2 * B, -3, np.int32), g])).to(dev)
    geom = blk[cuda_gather.WORDS * 2 * B:]
    args = [torch.from_numpy(x).to(dev) for x in (ab, alen, bb, blen)]
    nb = band.max_blocks_for(alen, blen)
    p = PARAMS["affine"]
    summ = torch.full((17, B), -1, dtype=torch.int32, device=dev)
    _build.reset_counts()
    res, desc = band.fill(p, 64, nb, False, *args, duo=(geom, summ[14:]))
    assert _build.LAUNCHES["duo"] == _build.LAUNCHES["fill"] == 1
    want = band.fill_plain(p, 64, nb, False, *args)
    assert_fill_equal(res, None, want, None)
    wdesc, dsum = duo.duo_window_plain(want.max_score, want.max_i,
                                       want.max_j, geom)
    assert torch.equal(desc, wdesc) and torch.equal(summ[14:], dsum)
    assert (summ[:14] == -1).all()
    if B > 2:
        assert (want.max_score[:2] == 0).all()


def _mapped(regs):
    return [None if r is None else (r.n_uniq, [
        (a.mapq, a.aid, dataclasses.asdict(a.aln)) for a in r.alns])
        for r in regs]


@pytest.mark.parametrize("case", ["reads", "past_262kb"])
def test_engine_duo_matches_two_step_on_cuda(case, dev, monkeypatch):
    """align_batch on the card with MINIALIGN_DUO=1 (the duo batch: one
    upload, gather, fill, duo window, gather, fill, walk) and =0 (down,
    then up): every Reg and Aln field equal. past_262kb maps a 270 kb
    read, past the TPU kernels' 2^18-character sides, which the JAX duo
    sends to its two-step _duo_slow."""
    from minialign_tpu_torch import params as tparams
    from minialign_tpu_torch.extend import FillEngine
    from minialign_tpu_torch.index.build import build_index
    from minialign_tpu_torch.pipeline import align_batch
    rng = np.random.default_rng(31)
    long = case == "past_262kb"
    genome = rng.integers(0, 4, 400_000 if long else 60_000).astype(np.int8)
    lens = [270_000] if long else [int(rng.integers(1500, 6000))
                                   for _ in range(8)]
    reads = []
    for n in lens:
        st = int(rng.integers(0, len(genome) - n))
        r = kbench.mutate(rng, genome[st:st + n].astype(np.int64), 0.05)
        reads.append(np.asarray(r if rng.random() < 0.5 else 3 - r[::-1],
                                np.int8))
    assert max(map(len, reads)) > 2**18 or not long
    mi = build_index(tparams.IndexParams(k=15, w=10), ["c"], [genome])
    mp = tparams.MapParams()
    out = {}
    for env in ("1", "0"):
        monkeypatch.setenv("MINIALIGN_DUO", env)
        _build.reset_counts()
        regs = align_batch(mp, mi, reads, FillEngine(mp.score, device=dev))
        out[env] = (_mapped(regs), dict(_build.LAUNCHES))
    assert out["1"][1]["duo"] > 0 and out["0"][1]["duo"] == 0
    assert out["1"][0] == out["0"][0]
    assert sum(r is not None for r in out["1"][0]) >= (1 if long else 6)


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
    """run2's ten cases; the timing loop on the tool's inputs and at the
    types' ends (int32 and int16 adds that wrap, bf16 past 256), one
    element a thread (int32, float32) or two rows a word (the others)."""
    rng = np.random.default_rng(13)
    for op, _, dtype in bf16ops.OPS:
        x, y = bf16ops.inputs(rng, dtype, dev)
        _same(bf16ops.run2(op, x, y, dev), bf16ops.run2_plain(op, x, y))
    for dtype in ("int32", "bfloat16"):
        x = bf16ops.timing_input(rng, dtype, dev)
        for n in (1, 64):
            _same(bf16ops.timing_loop(x, n, dev), bf16ops.timing_plain(x, n))
    for dtype in kbench.P3_EDGE_DTYPES:
        for B in kbench.LOOP_EDGE_C:
            x = kbench.timing_edge_input(rng, dtype, B, dev)
            for n in kbench.LOOP_EDGE_STEPS:
                _same(bf16ops.timing_loop(x, n, dev),
                      bf16ops.timing_plain(x, n))


def test_p4_kernels_match_plain(dev):
    """The three primitives and the stream on the tool's inputs; the
    stream and roll_in_carry on kbench's edge cases (C 1 / 33 / 128, steps
    around the 7-step pass, d outside [0, 7), words with the sign bit)."""
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
    for C in kbench.LOOP_EDGE_C:
        for kind in kbench.STREAM_D_KINDS:
            wa, wb, d = kbench.stream_edge_case(rng, C, kind, dev)
            for n in kbench.LOOP_EDGE_STEPS:
                _same(wordstream.stream_loop(wa, wb, d, n, dev),
                      wordstream.stream_timing_plain(wa, wb, d, n))
        w = tensor(rng.integers(-2**31, 2**31, (8, C)), "int32", dev)
        for rounds in kbench.ROLL_EDGE_ROUNDS:
            _same(wordstream.roll_in_carry(w, dev, rounds),
                  wordstream.roll_in_carry_plain(w, rounds))


# ---- P1 and P2 redesigned: packed lanes, edge inputs, the thin launch


@pytest.mark.parametrize("kind", kbench.PROBE_EDGE_KINDS)
@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16"])
def test_p1_kernel_on_edge_inputs(dtype, kind, dev):
    """Every op and carry of P1 at the type's edges, at an odd size, and
    on views one value past an aligned start (the scalar path)."""
    rng = np.random.default_rng(21)
    for op in subint32.BINOPS:
        x, y = kbench.probe_edge_pair(rng, dtype, kind, dev)
        _build.reset_counts()
        _same(subint32.probe(op, x, y, dev), subint32.probe_plain(op, x, y))
        assert _build.LAUNCHES["p1"] == 1
    for op in subint32.CARRY_OPS:
        x, y = kbench.probe_edge_pair(rng, dtype, kind, dev)
        _same(subint32.probe_carry(op, x, y, dev),
              subint32.probe_carry_plain(op, x, y))


@pytest.mark.parametrize("kind", kbench.PROBE_EDGE_KINDS)
@pytest.mark.parametrize("dtype", lowprec.DTYPES)
def test_p2_kernel_on_edge_inputs(dtype, kind, dev):
    rng = np.random.default_rng(22)
    for op in lowprec.BINOPS:
        x, y = kbench.probe_edge_pair(rng, dtype, kind, dev)
        _same(lowprec.elementwise(op, x, y, dev),
              lowprec.elementwise_plain(op, x, y))
    x, y = kbench.probe_edge_pair(rng, dtype, kind, dev)
    _same(lowprec.in_carry("maximum", x, y, dev),
          lowprec.in_carry_plain("maximum", x, y))
    _same(lowprec.in_carry("select", x, y, dev),
          lowprec.in_carry_plain("select", x, y))
    if kind != "odd":          # roll_concat takes (64, B)
        _same(lowprec.roll_concat(x, y, dev), lowprec.roll_concat_plain(x, y))


@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("dtype", ["int16", "bfloat16"])
def test_p2_packed_step_timer_matches_plain(dtype, B, dev):
    """The packed step timer at the checked step counts, and for int16
    from inputs near 32,767, where its adds wrap within 64 steps."""
    rng = np.random.default_rng(23)
    cases = [lowprec.step_inputs(rng, dtype, dev, B)]
    if dtype == "int16":
        cases.append(lowprec.step_inputs(rng, dtype, dev, B,
                                         *lowprec.WRAP_RANGE))
    for x, dd in cases:
        for n in (1, 64, 2048):
            _same(lowprec.step_loop(x, dd, n, dev),
                  lowprec.step_timer_plain(x, dd, n))


def test_probe_wrapper_takes_string_device_and_other_inputs(dev):
    """The thin path's slow side: a device named by string, numpy inputs
    and a non-contiguous tensor are moved, then launched."""
    rng = np.random.default_rng(24)
    x = rng.integers(-100, 100, (64, 128)).astype(np.int16)
    y = tensor(rng.integers(-100, 100, (128, 64)), "int16", dev).t()
    want = subint32.probe_plain("add", torch.from_numpy(x).to(dev),
                                y.contiguous())
    _build.reset_counts()
    _same(subint32.probe("add", x, y, "cuda"), want)
    assert _build.LAUNCHES["p1"] == 1


# ---- D3: the sharded lookup; the parallel paths on the card


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("kind", kbench.LOOKUP_KINDS)
def test_lookup_kernel_matches_plain(kind, n, dev):
    """kbench.LOOKUP_KINDS's tables split n ways: hashes past 2^63, the
    pad value, misses below and above, K = 0, unequal fill; one launch,
    word for word with lookup_plain's rows summed."""
    from minialign_tpu_torch.index.build import build_index
    from minialign_tpu_torch.params import IndexParams
    from minialign_tpu_torch.parallel import cuda_lookup, shard
    keys, off = kbench.lookup_table(kind, build_index, IndexParams)
    *t, q = kbench.lookup_tensors(
        torch, shard.shard_index_arrays(keys, off, n),
        kbench.lookup_queries(keys), dev)
    tree = cuda_lookup.build_tree(*t)
    _build.reset_counts()
    got = cuda_lookup.lookup(tree, q)
    assert _build.LAUNCHES["lookup"] == 1
    assert torch.equal(got, cuda_lookup.lookup_sum_plain(*t, q))
    assert cuda_lookup.lookup(tree, q[:0]).shape == (2, 0)
    assert _build.LAUNCHES["lookup"] == 1


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("K", kbench.LOOKUP_EDGE_K)
def test_lookup_kernel_on_edge_sizes(K, split, dev):
    """Shards of K keys (part pad and all pad) at 1, 2 and 8 shards (the
    top levels in shared memory: all of them, or at K = 4097 at 2 and 8
    shards one of two), the levels read whole or by sectors: word for
    word with lookup_plain's rows summed, on the tables themselves."""
    from minialign_tpu_torch.parallel import cuda_lookup
    for n in (1, 2, 8):
        tabs = kbench.lookup_edge_tables(K, n, seed=K * 10 + n)
        *t, q = kbench.lookup_tensors(
            torch, tabs, kbench.lookup_edge_queries(tabs[0]), dev)
        tree = cuda_lookup.build_tree(*t)
        got = cuda_lookup.lookup(tree, q, split)
        assert torch.equal(got, cuda_lookup.lookup_sum_plain(*t, q)), n


def _tref_reads(n, seed):
    from minialign_tpu_torch.io import bseq
    g = next(bseq.read_seqs(f"{DATA}/tref.fa")).codes
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        st = int(rng.integers(0, len(g) - 3000))
        s = g[st:st + int(rng.integers(800, 3000))].copy()
        r = rng.random(len(s))
        s = np.where(r < 0.05, rng.integers(0, 4, len(s)), s).astype(np.int8)
        out.append((3 - s)[::-1].copy() if rng.random() < 0.5 else s)
    return out


def test_sharded_engine_on_one_card_matches_single(dev):
    """ShardedFillEngine over [cuda:0, cuda:0] (two inner engines, two
    streams) returns one FillEngine's results, downs and traced ups."""
    from minialign_tpu_torch.extend import FillEngine
    from minialign_tpu_torch.parallel import shard
    rng = np.random.default_rng(7)
    reqs = []
    for i, a in enumerate(_tref_reads(9, 3)):
        b = kbench.mutate(rng, a).astype(np.int8)
        reqs.append(("up" if i % 2 else "down", a, b, (16, 32, 64)[i % 3]))
    p = MapParams().score
    _build.reset_counts()
    got = shard.ShardedFillEngine(p, [dev, dev]).run(reqs)
    assert _build.LAUNCHES["fill"] >= 2
    assert got == FillEngine(p, device=dev).run(reqs)


def test_align_batch_sharded_on_one_card(dev, monkeypatch):
    """align_batch_sharded over [cuda:0, cuda:0] with the native seeding
    off (so seeding goes through the lookup kernel) gives one engine's
    records."""
    from minialign_tpu_torch import native
    from minialign_tpu_torch.extend import FillEngine
    from minialign_tpu_torch.index.build import build_index
    from minialign_tpu_torch.io import bseq
    from minialign_tpu_torch.params import IndexParams
    from minialign_tpu_torch.parallel import shard
    from minialign_tpu_torch.pipeline import align_batch
    ref = list(bseq.read_seqs(f"{DATA}/tref.fa"))
    mi = build_index(IndexParams(), [s.name for s in ref],
                     [s.codes for s in ref])
    mp = MapParams()
    reads = _tref_reads(12, 5)
    want = align_batch(mp, mi, reads, FillEngine(mp.score, device=dev))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    _build.reset_counts()
    got = shard.align_batch_sharded(mp, mi, reads, [dev, dev])
    assert all(_build.LAUNCHES[k] > 0
               for k in ("lookup", "fill", "gather", "dtrace"))
    assert got == want


def test_cli_workers_on_cuda(dev, tmp_path):
    """The CLI with MINIALIGN_PROC_WORKERS=2 on the card (three batches
    of kbench.write_split_reads at -165537) gives the one-process output
    byte for byte, @PG included; both processes launch the kernels."""
    import subprocess
    reads = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    kbench.write_split_reads(reads, 65537)
    args = ["-t1", "-165537", f"{DATA}/tref.fa"] + reads
    outs, launches = [], []
    for n in ("1", "2"):
        logs = tmp_path / f"logs{n}"
        logs.mkdir()
        env = dict(os.environ, MINIALIGN_TORCH_DEVICE="cuda",
                   MINIALIGN_PROC_WORKERS=n, MINIALIGN_LAUNCH_LOG=str(logs))
        r = subprocess.run([sys.executable, "-m", "minialign_tpu_torch"]
                           + args, cwd=chip_smoke.ROOT, env=env,
                           capture_output=True, timeout=600)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        outs.append(r.stdout)
        launches.append(len(os.listdir(logs)))
        assert _build.worker_launches(str(logs))["fill"] > 0
    assert outs[0] == outs[1]
    assert launches == [1, 3]            # the parent and its two workers
