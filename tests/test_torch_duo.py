"""The port's fused down+up "duo" (dp/duo.py and FillEngine's duo batch)
against the JAX package, on the CPU (the plain gather, fill, walk and
duo_window_plain). Every comparison is exact.

  1. duo_window_plain against a numpy transcription of the up-window
     arithmetic of minialign_tpu/extend.py:710-722 and against the up
     requests that the JAX engine's _duo_slow (:826-845) makes, on edge
     geometry: failed downs, clipped tp, lna_u capped by tp0 or not, cp
     at 0, int64 bases past 2^31; band.fill with a duo geometry (the
     kernel's epilogue on the card) against fill, then duo_window_plain;
  2. the engine's duo requests against the JAX engine's _duo_slow on the
     same stores (XLA fill, host traceback);
  3. against the same requests sent as down, then up (MINIALIGN_DUO=0's
     two-step path), W 16 / 32 / 64 and empty windows mixed;
  4. the up fill and walk at the exact block budget, at the host bound
     the duo uses, and past it: equal;
  5. align_batch with MINIALIGN_DUO at 1 and 0 against the JAX package's
     align_batch (tests/tools/tpu_parity.py's duo case, shortened);
  6. one summary read-back per duo batch, none between its two fills.
"""

import dataclasses

import numpy as np
import pytest
import torch

from minialign_tpu.extend import FillEngine as JaxEngine
from minialign_tpu.extend import revcomp_codes
from minialign_tpu.index.build import build_index
from minialign_tpu.params import IndexParams, MapParams
from minialign_tpu.pipeline import align_batch as jax_align_batch
from minialign_tpu_torch import extend, kbench
from minialign_tpu_torch import params as tparams
from minialign_tpu_torch.dp import band, dtrace, duo
from minialign_tpu_torch.dp.cuda_gather import desc_fields, gather_pair
from minialign_tpu_torch.extend import FillEngine, _slice_cap
from minialign_tpu_torch.index.build import build_index as tbuild_index
from minialign_tpu_torch.pipeline import align_batch

CAPU_ADD = 4 * 64 + 2 * 96 + 64       # minialign_tpu/extend.py:703


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain fill and walk run thousands of tiny ops, which gain
    nothing from intra-op threads; with several pytest workers on the
    machine those threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- 1: the up-window arithmetic


def _numpy_up_window(c):
    """minialign_tpu/extend.py:710-722, in numpy (int64)."""
    ae = c["cp0"] + c["mi"]
    be = c["cp1"] + c["mj"]
    tp0 = np.clip(ae, 1, c["rlen"])
    tp1 = np.clip(be, 1, c["qlen"])
    ok = (c["score"] > 0).astype(np.int64)
    lna_u = np.minimum(2 * tp1 + CAPU_ADD, tp0) * ok
    offa_u = c["rvbase"] + (c["rlen"] - tp0)
    lnb_u = tp1 * ok
    offb_u = c["qub"] + (c["qlen"] - tp1)
    return lna_u, offa_u, lnb_u, offb_u


def _duo_slow_up_requests(c):
    """The up requests of the JAX engine's _duo_slow for these downs (its
    run stubbed), with their window lengths by its own _req_lens; one
    reference and one read a problem."""
    eng = object.__new__(JaxEngine)
    B = len(c["rlen"])
    eng._ref_len = [int(x) for x in c["rlen"]]
    eng._q_len = [int(x) for x in c["qlen"]]
    calls = []

    def run(reqs):
        calls.append(reqs)
        if len(calls) == 1:
            return [(int(c["score"][s]), int(c["mi"][s]), int(c["mj"][s]),
                     None) for s in range(B)]
        return [(0, 0, 0, None)] * len(reqs)
    eng.run = run
    reqs = [("duo", None, None, 64,
             (s, 0, s, int(c["rlen"][s]), int(c["qlen"][s]),
              int(c["cp0"][s]), int(c["cp1"][s]))) for s in range(B)]
    eng._duo_slow(reqs, list(range(B)), [None] * B)
    ups = calls[1]
    lens = [eng._req_lens(u[1], u[2]) for u in ups]
    return ups, lens


def _plain_window(c):
    geom = torch.from_numpy(duo.pack_geom(c["rvbase"], c["qub"], c["rlen"],
                                          c["qlen"], c["cp0"], c["cp1"]))
    t = [torch.as_tensor(c[k], dtype=torch.int32)
         for k in ("score", "mi", "mj")]
    return duo.duo_window_plain(*t, geom)


def test_duo_window_plain_matches_jax_arithmetic():
    c = kbench.duo_geometry()
    B = len(c["rlen"])
    desc, dsum = _plain_window(c)
    f = {k: v.numpy().astype(np.int64) for k, v in desc_fields(desc).items()}
    lna, offa, lnb, offb = _numpy_up_window(c)
    np.testing.assert_array_equal(f["base"][:B] + f["start"][:B], offa)
    np.testing.assert_array_equal(f["base"][B:] + f["start"][B:], offb)
    np.testing.assert_array_equal(f["base"], np.concatenate(
        [c["rvbase"], c["qub"]]))
    np.testing.assert_array_equal(f["cap"], np.concatenate([lna, lnb]))
    np.testing.assert_array_equal(f["elen"], np.concatenate([lna, lnb]))
    np.testing.assert_array_equal(f["seglen"], np.concatenate(
        [c["rlen"], c["qlen"]]))
    assert not f["wrap"].any()
    np.testing.assert_array_equal(dsum.numpy(), np.stack(
        [c["score"], c["mi"], c["mj"]]))
    # the edge cases are there: failed downs, both clips, both caps
    tp0 = np.clip(c["cp0"] + c["mi"], 1, c["rlen"])
    tp1 = np.clip(c["cp1"] + c["mj"], 1, c["qlen"])
    ok = c["score"] > 0
    assert (~ok).sum() >= 3 and (c["score"] < 0).any()
    assert (tp0 == 1).any() and (tp0 == c["rlen"]).any()
    assert (tp1 == 1).any() and (tp1 == c["qlen"]).any()
    assert ((lna == tp0) & ok).any() and ((lna < tp0) & ok).any()
    assert (c["rvbase"] >= 2**31).any()


def test_duo_window_plain_matches_duo_slow_requests():
    """Where the down scored (_duo_slow does not zero a failed down's
    windows; extend_read discards them either way)."""
    c = kbench.duo_geometry(seed=4)
    B = len(c["rlen"])
    f = {k: v.numpy() for k, v in desc_fields(_plain_window(c)[0]).items()}
    ups, lens = _duo_slow_up_requests(c)
    for s, ((_, au, bu, W), (la, lb)) in enumerate(zip(ups, lens)):
        assert W == 64 and au[:3] == ("ref", s, 1) and au[5] == 0
        assert bu[:3] == ("q", s, 1)          # rev 0: the other strand
        assert (f["start"][s], f["start"][B + s]) == (au[3], bu[3])
        if c["score"][s] > 0:
            assert (f["elen"][s], f["elen"][B + s]) == (la, lb), s
        else:
            assert f["elen"][s] == f["elen"][B + s] == 0


def test_duo_window_keeps_out_rows_and_refuses_other_devices():
    c = kbench.duo_geometry(seed=5, B=16)
    out = torch.full((17, 16), -1, dtype=torch.int32)
    geom = torch.from_numpy(duo.pack_geom(c["rvbase"], c["qub"], c["rlen"],
                                          c["qlen"], c["cp0"], c["cp1"]))
    t = [torch.as_tensor(c[k], dtype=torch.int32)
         for k in ("score", "mi", "mj")]
    _, dsum = duo.duo_window_plain(*t, geom, out=out[14:])
    assert dsum.data_ptr() == out[14].data_ptr()
    assert torch.equal(out[14:], torch.stack(t))
    assert (out[:14] == -1).all()
    # the window runs in the down fill (band.fill's duo epilogue): a
    # device without a fill, or a traced fill, is refused
    a, alen = (torch.from_numpy(x) for x in band.pad_codes(
        [np.zeros(16, np.int8)] * 16))
    p = tparams.MapParams().score
    with pytest.raises(ValueError, match="device"):
        band.fill(p, 16, 2, False, *(x.to("meta") for x in (a, alen, a, alen)),
                  duo=(geom.to("meta"), out[14:].to("meta")))
    with pytest.raises(ValueError, match="untraced"):
        band.fill(p, 16, 2, True, a, alen, a, alen, duo=(geom, out[14:]))


def _duo_fill_case(W, B=12, seed=2):
    """B down problems of ~300 bases at W (the first two empty, so their
    downs fail) and duo_geometry's edge geometry behind them."""
    ab, alen, bb, blen = kbench.pairs(band, seed, B, 300)
    ab[:2], alen[:2] = band.NCODE, 0
    c = kbench.duo_geometry(seed, B)
    geom = torch.from_numpy(duo.pack_geom(c["rvbase"], c["qub"], c["rlen"],
                                          c["qlen"], c["cp0"], c["cp1"]))
    nb = band.max_blocks_for(alen, blen)
    return [torch.from_numpy(x) for x in (ab, alen, bb, blen)], nb, geom


@pytest.mark.parametrize("W", [16, 32, 64])
def test_fill_duo_equals_fill_then_window(W):
    """band.fill(..., duo=(geom, out)) on the CPU: the FillResult of the
    plain fill, the up descriptor block and down rows of
    duo_window_plain on it, the rows written into `out` and nothing
    else of the summary touched."""
    args, nb, geom = _duo_fill_case(W)
    p = tparams.MapParams().score
    summ = torch.full((17, 12), -1, dtype=torch.int32)
    res, desc = band.fill(p, W, nb, False, *args, duo=(geom, summ[14:]))
    want = band.fill(p, W, nb, False, *args)
    for f in band.FillResult._fields:
        assert torch.equal(getattr(res, f), getattr(want, f)), f
    wdesc, wsum = duo.duo_window_plain(want.max_score, want.max_i,
                                       want.max_j, geom)
    assert torch.equal(desc, wdesc) and torch.equal(summ[14:], wsum)
    assert (summ[:14] == -1).all()
    assert (want.max_score[:2] == 0).all() and (want.max_score[2:] > 0).any()
    assert not desc_fields(desc)["elen"][[0, 1, 12, 13]].any()


# ---- 2-6: the engine


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(42).integers(0, 4, 9000).astype(np.int8)


def _mutate(rng, s, err=0.08):
    out = []
    for ch in s:
        r = rng.random()
        if r < err * 0.5:
            out.append(rng.integers(0, 4))
        elif r < err * 0.75:
            out += [rng.integers(0, 4), ch]
        elif r >= err:
            out.append(ch)
    return np.asarray(out, np.int8)


@pytest.fixture(scope="module")
def reads(genome):
    rng = np.random.default_rng(7)
    out = []
    for st, n, rev in ((1000, 1100, False), (4000, 900, True),
                       (6500, 1200, False)):
        r = _mutate(rng, genome[st:st + n])
        out.append((revcomp_codes(r) if rev else r, st, rev))
    return out


@pytest.fixture(scope="module")
def indexes(genome):
    return (build_index(IndexParams(), ["chr_t"], [genome]),
            tbuild_index(tparams.IndexParams(), ["chr_t"], [genome]))


@pytest.fixture(scope="module")
def engine(indexes, reads):
    eng = FillEngine(tparams.MapParams().score, batch=8, device="cpu")
    eng.set_index(indexes[1])
    eng.set_queries([r for r, _, _ in reads])
    return eng


def _duo_req(qidx, rev, cp0, cp1, W, rlen, qlen):
    """A duo request as extend_read makes it (minialign_tpu_torch/
    extend.py:678-687)."""
    cap = _slice_cap(qlen - cp1, W)
    return ("duo", ("ref", 0, 0, cp0, cap, 0), ("q", qidx, rev, cp1), W,
            (0, rev, qidx, rlen, qlen, cp0, cp1))


def _requests(genome, reads, Ws=(64, 32, 16)):
    """Duo requests: each read at its true start (the down scores), one
    off its diagonal, one whose query window is empty and one whose
    reference window is empty (both downs fail)."""
    rlen = len(genome)
    out = []
    for q, ((r, st, rev), W) in enumerate(zip(reads, Ws)):
        qlen = len(r)
        out.append(_duo_req(q, int(rev), st, 0, W, rlen, qlen))
        out.append(_duo_req(q, int(rev), st + 700, 50, W, rlen, qlen))
    out.append(_duo_req(0, 0, 10, len(reads[0][0]), 64, rlen,
                        len(reads[0][0])))
    out.append(_duo_req(1, 1, rlen, 0, 32, rlen, len(reads[1][0])))
    return out


def _same_trace(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    # the JAX walker's ops tokens come from its own host traceback
    assert {k: v for k, v in da.items() if k != "ops_rev"} == \
        {k: v for k, v in db.items() if k != "ops_rev"}


def test_engine_duo_matches_jax_duo_slow(engine, indexes, reads, genome):
    reqs = _requests(genome, reads, Ws=(64, 64, 64))
    reqs = reqs[:3] + reqs[-2:-1]          # one empty query window
    got = engine.run(reqs)
    jeng = JaxEngine(MapParams().score, use_pallas=False)
    jeng.set_index(indexes[0])
    jeng.set_queries([r for r, _, _ in reads])
    want = [None] * len(reqs)
    jeng._duo_slow(reqs, list(range(len(reqs))), want)
    assert any(w[0] > 0 for w in want) and any(w[0] == 0 for w in want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        if w[0] > 0:
            assert g[3:6] == w[3:6]
            _same_trace(g[6], w[6])


def _two_step(engine, reqs):
    """The same requests as down, then up (extend_read with duo off:
    minialign_tpu_torch/extend.py:697-729)."""
    downs = engine.run([("down",) + r[1:4] for r in reqs])
    ups, at = [], []
    for k, (r, d) in enumerate(zip(reqs, downs)):
        if d[0] == 0:
            continue
        rid, rev, qidx, rlen, qlen, cp0, cp1 = r[4]
        tp0 = min(max(cp0 + d[1], 1), rlen)
        tp1 = min(max(cp1 + d[2], 1), qlen)
        ups.append(("up", ("ref", rid, 1, rlen - tp0, _slice_cap(tp1, 64),
                           0), ("q", qidx, 1 - rev, qlen - tp1), 64))
        at.append(k)
    out = [d[:3] + (None,) * 4 for d in downs]
    for k, u in zip(at, engine.run(ups)):
        out[k] = downs[k][:3] + u
    return out


def test_engine_duo_matches_two_step(engine, reads, genome):
    reqs = _requests(genome, reads)
    assert {r[3] for r in reqs} == {16, 32, 64}
    got = engine.run(reqs)
    want = _two_step(engine, reqs)
    assert sum(w[0] == 0 for w in want) >= 2
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        if w[0] > 0:
            assert g[3:6] == w[3:6]
            assert dataclasses.asdict(g[6]) == dataclasses.asdict(w[6])
        else:                   # empty up windows: a zero score, no path
            assert g[3:6] == (0, 0, 0) and g[6].path == ""


@pytest.fixture(scope="module")
def exact_up_fill(engine, reads, genome):
    reqs = [r for r in _requests(genome, reads) if r[3] == 64]
    return reqs, _up_fill(engine, reqs, "exact")


def _up_fill(engine, reqs, budget):
    """The traced up fill and walk of the duo requests' up windows (from
    their downs) with the block budget and row lengths of `budget`:
    "exact" from the windows' own lengths, "bound" from the host bounds
    the duo uses (tp0 <= rlen, tp1 <= qlen), "past_bound" 9 blocks and
    one row step more."""
    c = {k: [] for k in ("score", "mi", "mj", "rvbase", "qub", "rlen",
                         "qlen", "cp0", "cp1")}
    for r, d in zip(reqs, engine.run([("down",) + r[1:4] for r in reqs])):
        rid, rev, qidx, rlen, qlen, cp0, cp1 = r[4]
        for k, v in zip(c, (*d[:3], engine._ref_rv[rid],
                            engine._q_bases[qidx][0 if rev else 1], rlen,
                            qlen, cp0, cp1)):
            c[k].append(v)
    c = {k: np.asarray(v, np.int64) for k, v in c.items()}
    desc, _ = _plain_window(c)
    B = len(reqs)
    e = desc_fields(desc)["elen"]
    if budget == "exact":
        la, lb = e[:B].numpy(), e[B:].numpy()
    else:
        la, lb = np.minimum(2 * c["qlen"] + CAPU_ADD, c["rlen"]), c["qlen"]
    more = 9 if budget == "past_bound" else 0
    nb = band.max_blocks_for(la, lb) + more
    La, Lb = (extend._row_len(x) + 16 * more for x in (la, lb))
    a, b = gather_pair(engine._ref_store, engine._q_store, desc, B, La, Lb)
    p = engine.p
    res, bufs = band.fill(p, 64, nb, True, a, e[:B], b, e[B:])
    rle, summ = dtrace.dtrace(p, 64, bufs.masks, bufs.dirs, bufs.iheads,
                              res.max_score, res.max_i, res.max_j)
    return nb, torch.stack(res[:4]), int(res.n_blocks), summ, \
        rle[:, :int(summ[1].max())]


@pytest.mark.parametrize("budget", ["bound", "past_bound"])
def test_up_fill_block_budget(budget, engine, exact_up_fill):
    """The duo sizes the up rows and the up fill's block budget from host
    bounds, never from the down result; at the bound and past it the fill
    and walk give what the exact budget gives."""
    reqs, (nb0, *want) = exact_up_fill
    nb, *got = _up_fill(engine, reqs, budget)
    assert nb > nb0
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


@pytest.fixture(scope="module")
def pipeline_case():
    """tests/tools/tpu_parity.py's duo case, cut to 4 reads of 1.5-3 kb
    on a 30 kb genome for the plain CPU path."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 30_000).astype(np.int8)
    reads = []
    for _ in range(4):
        n = int(rng.integers(1500, 3000))
        st = int(rng.integers(0, len(genome) - n))
        r = _mutate(rng, genome[st:st + n])
        reads.append(revcomp_codes(r) if rng.random() < 0.5 else r)
    return (build_index(IndexParams(k=15, w=10), ["c"], [genome]),
            tbuild_index(tparams.IndexParams(k=15, w=10), ["c"], [genome]),
            reads)


@pytest.mark.parametrize("duo_env", ["1", "0"])
def test_align_batch_duo_on_and_off_match_jax(duo_env, pipeline_case,
                                              monkeypatch):
    index, tindex, reads = pipeline_case
    mp = MapParams()
    eng = FillEngine(tparams.MapParams().score, device="cpu")
    kinds = []
    run = eng.run
    monkeypatch.setattr(eng, "run", lambda reqs: kinds.extend(
        r[0] for r in reqs) or run(reqs))
    monkeypatch.setenv("MINIALIGN_DUO", duo_env)
    got = align_batch(tparams.from_fields(mp), tindex, reads, eng)
    assert ("duo" in kinds) == (duo_env == "1")
    assert ("up" in kinds) == (duo_env == "0")
    want = _JAX_REGS.get("regs")
    if want is None:
        want = _JAX_REGS["regs"] = jax_align_batch(mp, index, reads)
    assert len(got) == len(want)
    assert sum(w is not None for w in want) >= 3
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), k
        if w is None:
            continue
        assert g.n_uniq == w.n_uniq, k
        assert [(ga.mapq, ga.aid, dataclasses.asdict(ga.aln))
                for ga in g.alns] == \
            [(wa.mapq, wa.aid, dataclasses.asdict(wa.aln))
             for wa in w.alns], k


_JAX_REGS = {}


def test_one_summary_read_back_per_duo_batch(engine, reads, genome,
                                             monkeypatch):
    """A duo batch reads back its summary (the walk's rows and the down
    rows together) and then its run-length entries, and nothing between
    its down fill and its up fill."""
    log = []
    host, fill = extend._host, extend.fill

    def fill_logged(p, W, nb, trace, *args, **kw):
        log.append(("fill", trace))
        return fill(p, W, nb, trace, *args, **kw)

    def host_logged(t):
        log.append(("read", tuple(t.shape)))
        return host(t)
    monkeypatch.setattr(extend, "fill", fill_logged)
    monkeypatch.setattr(extend, "_host", host_logged)
    reqs = _requests(genome, reads, Ws=(32, 32, 32))[:2]
    keys = {r[3:4] + (extend._bucket(engine._spec_len(r[1]) + 224),
                      extend._bucket(engine._spec_len(r[2]) + 224),
                      extend._bucket(min(2 * r[4][4] + CAPU_ADD, r[4][3])
                                     + 224),
                      extend._bucket(r[4][4] + 224)) for r in reqs}
    engine.run(reqs)
    n = len(keys)
    fills = [e for e in log if e[0] == "fill"]
    assert fills == [("fill", False), ("fill", True)] * n
    first_read = next(k for k, e in enumerate(log) if e[0] == "read")
    assert first_read == 2 * n              # every batch launched first
    reads_ = log[first_read:]
    assert len(reads_) == 2 * n and all(e[0] == "read" for e in reads_)
    assert all(e[1][0] == len(dtrace.SUMMARY_ROWS) + 3 for e in reads_[::2])
