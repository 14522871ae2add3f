"""Port gather (minialign_tpu_torch.dp.cuda_gather.gather_plain and the
two-sided packed form gather_pair_plain) against the JAX engine's XLA
gather (FillEngine._gather_fn) and host slicing, with circular wrap on
and off, on every edge case of the kernel's paths
(minialign_tpu_torch.kbench.GATHER_KINDS). Byte-equal rows required."""

import numpy as np
import pytest
import torch

from minialign_tpu.extend import FillEngine as JaxEngine
from minialign_tpu.params import ScoreParams
from minialign_tpu_torch import extend, kbench
from minialign_tpu_torch.dp import cuda_gather

NCODE = 4
L_EDGE, B_EDGE = 256, 4


@pytest.fixture(scope="module")
def jax_engine():
    return JaxEngine(ScoreParams(), use_pallas=False)


def _case(seed, wrap):
    rng = np.random.default_rng(seed)
    segs = [int(rng.integers(50, 900)) for _ in range(3)]
    flat = np.concatenate([rng.integers(0, 4, n) for n in segs]).astype(
        np.int8)
    bases = np.cumsum([0] + segs[:-1])
    B, L = 12, 1024
    k = rng.integers(0, 3, B)
    base = bases[k].astype(np.int32)
    seglen = np.asarray(segs, np.int32)[k]
    start = np.asarray([int(rng.integers(0, s + 40)) for s in seglen],
                       np.int32)
    cap = rng.integers(0, 1200, B).astype(np.int32)
    cap[0] = 0                                    # empty row
    start[1] = seglen[1]                          # window at the seg end
    wr = (seglen if wrap else np.zeros(B)).astype(np.int32)
    return flat, base, start, cap, seglen, wr, L


def _host(flat, base, start, cap, seglen, wrap, L):
    """The contract column by column: idx = start + col, taken mod wrap
    when wrap > 0 and else kept only below seglen, clipped into
    [0, seglen - 1]; NCODE from cap on and for an empty segment."""
    out = np.full((len(base), L), NCODE, np.int8)
    for b in range(len(base)):
        if seglen[b] <= 0:
            continue
        for col in range(min(L, cap[b])):
            idx = int(start[b]) + col
            if wrap[b]:
                idx %= int(wrap[b])
            elif idx >= seglen[b]:
                continue
            out[b, col] = flat[base[b] + min(max(idx, 0), seglen[b] - 1)]
    return out


def _jax(engine, flat, base, start, cap, seglen, wrap, L):
    return np.asarray(engine._gather_fn(L)(flat, base, start, cap, seglen,
                                           wrap))


@pytest.mark.parametrize("wrap", [False, True])
def test_gather_plain_matches_jax_and_host(wrap, jax_engine):
    flat, base, start, cap, seglen, wr, L = _case(7 + wrap, wrap)
    got = cuda_gather.gather_plain(torch.from_numpy(flat), base, start, cap,
                                   seglen, wr, L).numpy()
    want = _jax(jax_engine, flat, base, start, cap, seglen, wr, L)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host(flat, base, start, cap,
                                             seglen, wr, L))


def test_gather_dispatch_cpu():
    """The gather on a CPU store is its plain version."""
    flat, base, start, cap, seglen, wr, L = _case(3, False)
    store = torch.from_numpy(flat)
    side = dict(base=base, start=start, cap=cap, seglen=seglen, wrap=wr,
                elen=np.minimum(cap, L))
    blk = torch.from_numpy(cuda_gather.pack_desc([side, side]))
    got = cuda_gather.gather_pair(store, store, blk, len(base), L, L)
    want = cuda_gather.gather_plain(store, base, start, cap, seglen, wr, L)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


def _edge(kind, k, seed):
    """B_EDGE rows of one kind on a gather_store for L_EDGE columns."""
    rng = np.random.default_rng(seed)
    flat, bases, lens = kbench.gather_store(rng, L_EDGE)
    rows = [kbench.gather_row(kind, rng, bases, lens, L_EDGE, k)
            for _ in range(B_EDGE)]
    return (flat, *(np.asarray(x, np.int32) for x in zip(*rows)))


def _check_edge(engine, flat, base, start, cap, seglen, wrap):
    """gather_plain == _gather_fn == _host, and both sides of the packed
    two-sided form on the padded store give the same rows."""
    L = L_EDGE
    got = cuda_gather.gather_plain(torch.from_numpy(flat), base, start, cap,
                                   seglen, wrap, L).numpy()
    np.testing.assert_array_equal(
        got, _jax(engine, flat, base, start, cap, seglen, wrap, L))
    np.testing.assert_array_equal(
        got, _host(flat, base, start, cap, seglen, wrap, L))
    side = dict(base=base, start=start, cap=cap, seglen=seglen, wrap=wrap,
                elen=np.minimum(cap, L))
    store = torch.from_numpy(cuda_gather.pad_store(flat))
    a, b = cuda_gather.gather_pair(
        store, store, torch.from_numpy(cuda_gather.pack_desc([side, side])),
        len(base), L, L)
    np.testing.assert_array_equal(a.numpy(), got)
    np.testing.assert_array_equal(b.numpy(), got)
    return got


@pytest.mark.parametrize("residue", range(16))
def test_gather_window_start_residue(residue, jax_engine):
    flat, base, start, *rest = _edge("residue", residue, residue)
    assert all((base + start) % 16 == residue)
    _check_edge(jax_engine, flat, base, start, *rest)


@pytest.mark.parametrize("before", [0, 1, 8, 15])
def test_gather_window_ending_at_store_end(before, jax_engine):
    """A window whose last column is the store's last byte (before=0) or
    lies `before` bytes ahead of it."""
    flat, base, start, cap, seglen, wrap = _edge("store_end", before, 40)
    assert all(base + start + L_EDGE - 1 == len(flat) - 1 - before)
    got = _check_edge(jax_engine, flat, base, start, cap, seglen, wrap)
    assert (got[:, -1] == flat[-1 - before]).all()


@pytest.mark.parametrize("past", [0, 15])
def test_gather_window_past_store_end(past, jax_engine):
    flat, *rest = _edge("past_store_end", past, 41)
    got = _check_edge(jax_engine, flat, *rest)
    assert (got[:, -1 - past:] == NCODE).all()


@pytest.mark.parametrize("kind", ["wrap_lt", "wrap_eq", "wrap_gt",
                                  "wrap_tiny"])
def test_gather_wrap(kind, jax_engine):
    """wrap below the segment length (and below 16), at it, and above it
    (the columns past the segment read its last base)."""
    flat, base, start, cap, seglen, wrap = _edge(kind, 0, 42)
    assert all({"wrap_lt": wrap < seglen, "wrap_eq": wrap == seglen,
                "wrap_gt": wrap > seglen, "wrap_tiny": wrap < 40}[kind])
    _check_edge(jax_engine, flat, base, start, cap, seglen, wrap)


@pytest.mark.parametrize("kind", ["neg_start", "neg_start_wrap"])
def test_gather_negative_start(kind, jax_engine):
    flat, base, start, *rest = _edge(kind, 0, 43)
    assert all(start < 0)
    _check_edge(jax_engine, flat, base, start, *rest)


@pytest.mark.parametrize("kind", ["cap_0", "cap_gt_L"])
def test_gather_cap(kind, jax_engine):
    flat, base, start, cap, *rest = _edge(kind, 0, 44)
    assert all(cap == 0) if kind == "cap_0" else all(cap > L_EDGE)
    got = _check_edge(jax_engine, flat, base, start, cap, *rest)
    if kind == "cap_0":
        assert (got == NCODE).all()


def test_gather_empty_segment(jax_engine):
    flat, base, start, cap, seglen, wrap = _edge("seglen_0", 0, 45)
    assert all(seglen == 0)
    got = _check_edge(jax_engine, flat, base, start, cap, seglen, wrap)
    assert (got == NCODE).all()


def test_gather_start_at_or_past_segment_end(jax_engine):
    flat, base, start, cap, seglen, wrap = _edge("start_ge_seglen", 0, 46)
    assert all(start >= seglen)
    got = _check_edge(jax_engine, flat, base, start, cap, seglen, wrap)
    assert (got == NCODE).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_pair_plain_matches_two_gathers_and_jax(seed, jax_engine):
    """Random batches over every kind, unequal rows and L a side, each
    side from its own store: the packed two-sided form equals a
    gather_plain per side and _gather_fn."""
    rng = np.random.default_rng(100 + seed)
    (Ba, La), (Bb, Lb) = (3 + seed, 128), (5, 384)
    (fa, sa), (fb, sb) = (kbench.gather_side(rng, L, B)
                          for B, L in ((Ba, La), (Bb, Lb)))
    blk = torch.from_numpy(cuda_gather.pack_desc([sa, sb]))
    got = cuda_gather.gather_pair(torch.from_numpy(cuda_gather.pad_store(fa)),
                                  torch.from_numpy(cuda_gather.pad_store(fb)),
                                  blk, Ba, La, Lb)
    assert got[0].shape == (Ba, La) and got[1].shape == (Bb, Lb)
    for g, f, s, L in zip(got, (fa, fb), (sa, sb), (La, Lb)):
        meta = [s[k].astype(np.int32) for k in kbench.SIDE]
        np.testing.assert_array_equal(g.numpy(), cuda_gather.gather_plain(
            torch.from_numpy(f), *meta, L).numpy())
        np.testing.assert_array_equal(g.numpy(),
                                      _jax(jax_engine, f, *meta, L))


def test_gather_padded_store_gives_the_same_rows():
    rng = np.random.default_rng(7)
    flat, side = kbench.gather_side(rng, L_EDGE, 2 * len(kbench.GATHER_KINDS))
    padded = cuda_gather.pad_store(flat)
    assert len(padded) % 16 == 0 and len(padded) >= len(flat) + 16
    assert (padded[len(flat):] == NCODE).all()
    meta = [side[k] for k in kbench.SIDE]
    assert torch.equal(
        cuda_gather.gather_plain(torch.from_numpy(padded), *meta, L_EDGE),
        cuda_gather.gather_plain(torch.from_numpy(flat), *meta, L_EDGE))


def test_pack_desc_fields_round_trip():
    rng = np.random.default_rng(8)
    sides = [kbench.gather_side(rng, 128, B)[1] for B in (3, 2)]
    sides[0]["base"][0] = 5_000_000_000           # past 32 bits
    f = cuda_gather.desc_fields(torch.from_numpy(
        cuda_gather.pack_desc(sides)))
    for k in ("base",) + cuda_gather.FIELDS:
        want = np.concatenate([s[k] for s in sides])
        np.testing.assert_array_equal(f[k].numpy(), want)
    assert f["base"].dtype == torch.int64 and f["elen"].dtype == torch.int32


def _engine_run(seqs):
    """Two 'down' requests (one batch: batch=2, one length bucket) and
    one 'up' through a CPU FillEngine, from the device stores ("store")
    or from raw code arrays ("raw", MINIALIGN_DEVICE_SEQS=0)."""
    from minialign_tpu_torch.index.build import build_index
    from minialign_tpu_torch.params import IndexParams, MapParams
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 3000).astype(np.int8)
    starts, lens = (100, 900, 2000), (300, 320, 310)
    reads = [ref[s:s + n].copy() for s, n in zip(starts, lens)]
    kinds = ("down", "up", "down")
    eng = extend.FillEngine(MapParams().score, batch=2, device="cpu")
    if seqs == "store":
        eng.set_index(build_index(IndexParams(), ["r"], [ref]))
        eng.set_queries(reads)
        reqs = [(k, ("ref", 0, 0, s, n + 64, 0), ("q", i, 0, 0), 16)
                for i, (k, s, n) in enumerate(zip(kinds, starts, lens))]
    else:
        reqs = [(k, ref[s:s + n + 64], q, 16)
                for k, s, n, q in zip(kinds, starts, lens, reads)]
    return eng.run(reqs)


@pytest.mark.parametrize("seqs", ["store", "raw"])
def test_engine_uploads_once_per_batch(seqs, monkeypatch):
    """FillEngine.run builds each fill batch from one upload of its packed
    block (and, for raw code arrays, one of the batch's store) and one
    gather launch for both sides; the fill reads its lengths from that
    block. Both paths give the same results."""
    calls = {"upload": 0, "gather": 0, "fill": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    with monkeypatch.context() as m:
        m.setattr(extend, "upload", counted("upload", extend.upload))
        m.setattr(extend, "gather_pair", counted("gather",
                                                 extend.gather_pair))
        m.setattr(extend, "fill", counted("fill", extend.fill))
        out = _engine_run(seqs)
    assert calls["fill"] == 2        # the two 'down' requests, the 'up'
    assert calls["gather"] == calls["fill"]
    assert calls["upload"] == (1 if seqs == "store" else 2) * calls["fill"]
    assert all(score > 0 for score, *_ in out)
    assert [tr is not None for *_, tr in out] == [False, True, False]
    assert out == _engine_run("raw" if seqs == "store" else "store")
