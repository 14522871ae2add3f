"""The batch seed pass (minialign_tpu_torch/index/seed_device.py) on the CPU:
its plain version, run over a whole batch as FillEngine.seed_round0 runs it
on the query store, equal read by read to the port's chain.collect_seeds
(the host library's collect_seeds_c where it loads) and to the JAX
package's minialign_tpu.chain.collect_seeds on the same index: every
read's seeds in order, its rescue rows and their counts. Then align_batch
with the pass (the CPU engine with the CPU among its seed_devices, so the
plain version runs) against align_batch without it, and the paths that
keep seeding a read at a time. The kernel itself is held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from minialign_tpu_torch import chain, extend, stats
from minialign_tpu_torch.extend import FillEngine, seeds_read
from minialign_tpu_torch.index import seed_device
from minialign_tpu_torch.index.build import build_index
from minialign_tpu_torch.params import IndexParams, MapParams
from minialign_tpu_torch.parallel import shard
from minialign_tpu_torch.pipeline import align_batch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genome(seed=3, n=30000):
    """Random bases with a 300-base block repeated 12 times and a 200-base
    block 5 times, so that some keys have runs long enough to be rescued
    or dropped."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.int8)
    for copies, size, at in ((12, 300, 1000), (5, 200, 20000)):
        rep = rng.integers(0, 4, size).astype(np.int8)
        for i in range(copies):
            g[at + 1500 * i:at + 1500 * i + size] = rep
    return g


def _index(k=15, w=10, occ=None):
    mi = build_index(IndexParams(k=k, w=w), ["chr_s"], [_genome()])
    assert seed_device.eligible(mi)
    if occ is not None:
        mi = dataclasses.replace(mi, occ=np.asarray(occ, np.uint32))
    return mi


def _pieces(rng, g, n, lo, hi, n_rate=0.0):
    out = []
    for _ in range(n):
        st = int(rng.integers(0, len(g) - hi))
        r = g[st:st + int(rng.integers(lo, hi))].copy()
        if n_rate:
            r[rng.random(len(r)) < n_rate] = 4
        if rng.random() < 0.5:
            r = extend.revcomp_codes(r)
        out.append(r)
    return out


def _case(name):
    """(index, reads) of one case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    g = _genome()
    if name == "random":
        return _index(), _pieces(rng, g, 12, 200, 3000)
    if name == "with_n":
        return _index(), _pieces(rng, g, 8, 200, 2000, n_rate=0.05) + [
            np.full(500, 4, np.int8)]
    if name == "short":
        # shorter than k, exactly k, between k and k + w, k + w and one more
        return _index(), [g[100:100 + L].copy()
                          for L in (1, 14, 15, 16, 20, 24, 25, 26)]
    if name == "empty":
        return _index(), [np.zeros(0, np.int8), g[:1000].copy(),
                          np.zeros(0, np.int8)]
    if name == "rescue_and_drop":
        # the first repeat's keys have ~12 hits, dropped above max_occ =
        # 8; the second's ~5, rescued above occ0 = 2
        reads = [g[900:2700].copy(), g[19900:21800].copy()]
        return _index(occ=(2, 4, 8)), reads + _pieces(rng, g, 4, 500, 2000)
    if name == "long":
        # several of the kernel's tiles of 1,024 positions a read
        return _index(), _pieces(rng, g, 3, 4000, 12000, n_rate=0.01)
    if name == "k16_w64":
        return _index(k=16, w=64), _pieces(rng, g, 6, 100, 3000)
    if name == "k5_w1":
        return _index(k=5, w=1), _pieces(rng, g, 4, 1, 400)
    if name == "k13_w24":
        # csrc/seed.cu's sliding minimum over two threads a w-block
        return _index(k=13, w=24), _pieces(rng, g, 4, 100, 6000)
    raise ValueError(name)


def _engine(reads, device="cpu"):
    eng = FillEngine(MapParams().score, device=device)
    eng.set_queries([np.asarray(r, np.int8) for r in reads])
    return eng


def _jax_index(mi):
    """The JAX package's MMIndex over the same arrays as mi."""
    from minialign_tpu.index.build import MMIndex
    return MMIndex(**{f.name: getattr(mi, f.name)
                      for f in dataclasses.fields(MMIndex)})


def _same(got, mi, read, jmi=None):
    """got, a read's (upos, vpos, rid, resc), against the port's
    collect_seeds and, with jmi (_jax_index), the JAX package's."""
    wants = [chain.collect_seeds(mi, read)]
    if jmi is not None:
        from minialign_tpu import chain as jchain
        wants.append(jchain.collect_seeds(jmi, read))
    for want in wants:
        for g, w in zip(got, (want.upos, want.vpos, want.rid, want.resc)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)
    return len(wants[0].upos), len(wants[0].resc)


CASES = ["random", "with_n", "short", "empty", "rescue_and_drop", "long",
         "k16_w64", "k5_w1", "k13_w24"]


@pytest.mark.parametrize("case", CASES + ["length_test"])
def test_batch_pass_equals_collect_seeds(case):
    """The plain batch pass over a batch's query store gives each read what
    collect_seeds gives it, the port's and the JAX package's: seeds in
    order, rescue rows, their counts."""
    if case == "length_test":
        # the reads extend_read's length test keeps, as align_batch passes
        # them: shorter than k, or too short for min_score, are skipped
        mi, _ = _case("random")
        g = _genome()
        reads = [g[:10].copy(), g[200:1200].copy(), g[300:320].copy(),
                 g[2000:4000].copy(), np.zeros(0, np.int8)]
        mp = MapParams()
        idxs = [i for i, r in enumerate(reads) if seeds_read(mp, mi, len(r))]
        assert idxs == [1, 3]
    else:
        mi, reads = _case(case)
        idxs = list(range(len(reads)))
    got = _engine(reads).seed_round0(mi, idxs)
    assert list(got) == idxs
    jmi = _jax_index(mi)
    n_seed = n_resc = 0
    for i in idxs:
        s, r = _same(got[i], mi, reads[i], jmi)
        n_seed += s
        n_resc += r
    if case in ("random", "with_n", "long", "k16_w64", "length_test"):
        assert n_seed > 0
    if case == "rescue_and_drop":
        assert n_resc > 0


def test_split_counts_match_sums():
    """The per-read sums cut the packed output exactly: their last row is
    the totals, and rescue starts come back as uint32 values."""
    mi, reads = _case("rescue_and_drop")
    eng = _engine(reads)
    off = np.asarray([b[0] for b in eng._q_bases], np.int64)
    ln = np.asarray(eng._q_len, np.int64)
    tab = seed_device.tables(mi, torch.device("cpu"))
    sums, out = seed_device.seed_pass(eng._q_store, off, ln, tab, mi.k,
                                      mi.w, mi.max_occ, int(mi.occ[0]))
    assert sums.shape == (len(reads) + 1, 2) and (sums[0] == 0).all()
    assert out.numel() == 3 * int(sums[-1].sum())
    parts = seed_device.split(sums, out.numpy())
    assert [len(p[0]) for p in parts] == list(np.diff(sums[:, 0]))
    assert [len(p[3]) for p in parts] == list(np.diff(sums[:, 1]))


def _reads_for_map(seed=7):
    rng = np.random.default_rng(seed)
    g = _genome()
    reads = _pieces(rng, g, 5, 800, 2500, n_rate=0.01)
    return reads + [g[1000:1300].copy(), np.zeros(10, np.int8)]


def _regs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert dataclasses.asdict(x) == dataclasses.asdict(y)


def test_align_batch_with_pass_equals_without(monkeypatch):
    """align_batch on the CPU engine with the CPU among its seed_devices
    (the plain batch pass; collect_seeds never called) gives the regs and
    the thread buffer that its default path (collect_seeds a read)
    gives."""
    mi, mp = _index(), MapParams()
    reads = _reads_for_map()
    calls = []
    orig = extend.collect_seeds

    def counted(m, q):
        calls.append(len(q))
        return orig(m, q)
    monkeypatch.setattr(extend, "collect_seeds", counted)
    monkeypatch.delenv("MINIALIGN_DEVICE_SEQS", raising=False)
    tb0 = {"rlen": 0}
    want = align_batch(mp, mi, reads, FillEngine(mp.score, device="cpu"),
                       tbuf=tb0)
    n_kept = sum(seeds_read(mp, mi, len(r)) for r in reads)
    assert len(calls) >= n_kept
    calls.clear()
    monkeypatch.setattr(FillEngine, "seed_devices", ("cuda", "cpu"))
    tb1 = {"rlen": 0}
    stats.reset()
    stats.start()
    try:
        got = align_batch(mp, mi, reads,
                          FillEngine(mp.score, device="cpu"), tbuf=tb1)
        rec = stats.read()
    finally:
        stats.stop()
        stats.reset()
    assert calls == []
    assert rec["counters"]["pipeline.seed_batched"] == n_kept
    assert rec["counters"]["pipeline.reads"] == len(reads)
    assert rec["spans"]["pipeline.seed"]["count"] >= 1
    _regs_equal(got, want)
    assert sum(r is not None for r in got) >= 4
    assert tb0 == tb1


@pytest.mark.parametrize("path", ["sharded", "k_over_16", "cpu_default"])
def test_other_paths_seed_each_read(path, monkeypatch):
    """The sharded engine, an index with k > 16 and the CPU engine on its
    default path never run the batch pass: each kept read calls
    collect_seeds. The first two with the CPU among FillEngine's
    seed_devices, so that only the engine or the index keeps it off."""
    mp = MapParams()
    reads = _reads_for_map(11)[:4]
    if path == "k_over_16":
        mi = build_index(IndexParams(k=17, w=11), ["chr_s"], [_genome()])
        assert not seed_device.eligible(mi)
    else:
        mi = _index()
    monkeypatch.delenv("MINIALIGN_DEVICE_SEQS", raising=False)
    if path != "cpu_default":
        monkeypatch.setattr(FillEngine, "seed_devices", ("cuda", "cpu"))
    assert FillEngine(mp.score, device="cpu").seeds_batch(mi) == (
        path == "sharded")

    def refused(*a, **kw):
        raise AssertionError("the batch seed pass ran")
    calls = []
    orig = extend.collect_seeds

    def counted(m, q):
        calls.append(len(q))
        return orig(m, q)
    monkeypatch.setattr(seed_device, "seed_pass", refused)
    monkeypatch.setattr(extend, "collect_seeds", counted)
    if path == "sharded":
        got = shard.align_batch_sharded(mp, mi, reads,
                                        shard.make_mesh(2, "cpu"))
    else:
        got = align_batch(mp, mi, reads, FillEngine(mp.score, device="cpu"))
    assert len(calls) >= sum(seeds_read(mp, mi, len(r)) for r in reads) > 0
    assert sum(r is not None for r in got) >= 2


U64 = np.uint64


def _revcomp_words(W):
    """csrc/sketch_core.cuh's revcomp on uint64 words < 2^32: the
    complemented codes in reverse order."""
    y = W
    for sh, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                  (8, 0x00FF00FF), (16, 0x0000FFFF)):
        y = ((y >> U64(sh)) & U64(m)) | ((y & U64(m)) << U64(sh))
    return ~(((y & U64(0x55555555)) << U64(1))
             | ((y >> U64(1)) & U64(0x55555555))) & U64(0xFFFFFFFF)


def seed_count_model(store, off, L, k, w):
    """csrc/seed.cu's seed_count up to its lookups, in numpy, for the read
    store[off:off + L]: tile by tile of seed_device.TILE positions, the
    codes from slot 0's (position p0 - w) packed 16 to a word from a
    multiple of 16 in the store, each word's reverse complement beside
    it; each slot's k-mers by funnel shifts and its v; the windows' minima
    by van Herk / Gil-Werman on w-blocks of slots, each block's in
    seed_device.lanes(w) segments, kept as the kernel keeps them
    ([offset in w-block][w-block] words, found by slot_at's
    multiply-high); the emitted minimizers by the emit rule. Returns their (hash, pos, strand) in position order."""
    TILE = seed_device.TILE
    S, G = seed_device.lanes(w)
    n = L - k + 1
    nb = (TILE + 2 * w - 1) // w
    ns = nb * w
    big = U64(0xFFFFFFFFFFFFFFFF)
    mask = U64((1 << (2 * k)) - 1)
    m32 = U64(0xFFFFFFFF)
    out = ([], [], [])
    for p0 in range(0, max(n, 0), TILE):
        c0 = p0 - w
        g0 = off + c0
        gb = g0 & ~15
        d0 = g0 - gb
        nw = (ns + k - 2 + d0) // 16 + 2
        q = gb - off + np.arange(16 * (nw + 1))
        inside = (q >= 0) & (q < L)
        c = np.where(inside, store[off + np.clip(q, 0, max(L - 1, 0))]
                     .astype(np.int64) & 3, 0)
        W = (c.reshape(nw + 1, 16).astype(U64)
             << (U64(30) - U64(2) * np.arange(16, dtype=U64))).sum(
                 1, dtype=U64)
        R = _revcomp_words(W)
        j = np.arange(ns)
        o = j + d0
        i, s2 = o >> 4, U64(2) * (o & 15).astype(U64)
        k0 = ((((W[i] << U64(32)) | W[i + 1]) << s2) >> U64(32) & m32) \
            >> U64(32 - 2 * k)
        k1 = (((R[i + 1] << U64(32)) | R[i]) >> s2) & mask
        strand = (k1 <= k0).astype(U64)
        h = np.where(strand == 1, k1, k0)
        p = c0 + j
        v = (h << U64(8)) | (np.mod(p, w).astype(U64)) | (strand << U64(7))
        v[(p < 0) | (p >= n)] = big
        kb = np.full((nb, S * G), big)
        kb[:, :w] = v.reshape(nb, w)
        kb = kb.reshape(nb, S, G)
        z = kb.min(2)
        cp = np.minimum.accumulate(np.concatenate(
            [np.full((nb, 1), big), z[:, :-1]], 1), axis=1)
        cs = np.minimum.accumulate(np.concatenate(
            [z[:, 1:], np.full((nb, 1), big)], 1)[:, ::-1], axis=1)[:, ::-1]
        pre = np.minimum(np.minimum.accumulate(kb, axis=2), cp[:, :, None])
        suf = np.minimum(np.minimum.accumulate(kb[:, :, ::-1], axis=2)
                         [:, :, ::-1], cs[:, :, None])
        # the kernel's [offset in w-block][w-block] words, nbp a row, slot
        # s's found by slot_at (s / w by a multiply-high)
        nbp = nb | 1
        wm = ((1 << 32) // w + 1) & 0xFFFFFFFF

        def at(sl):
            blk = (sl * wm) >> 32
            if w == 1:
                blk = blk + sl
            return (sl - blk * w) * nbp + blk
        PA = np.full(w * nbp, big)
        SA = np.full(w * nbp, big)
        PA[at(j)] = pre.reshape(nb, S * G)[:, :w].reshape(-1)
        SA[at(j)] = suf.reshape(nb, S * G)[:, :w].reshape(-1)
        a = at(np.arange(w - 1, TILE + w))
        inner = a < (w - 1) * nbp
        PA[a[inner]] = np.minimum(PA[a[inner]], SA[a[inner] + nbp - 1])
        pp = p0 + np.arange(min(TILE, n - p0))
        s = w + pp - p0
        m = PA[at(s)]
        back = np.mod(np.mod(pp, w) - (m & U64(0x7F)).astype(np.int64), w)
        e = (pp == 0) | (m != PA[at(s - 1)]) | (back == 0)
        out[0].append(m[e] >> U64(8))
        out[1].append((pp - back)[e])
        out[2].append(((m[e] >> U64(7)) & U64(1)).astype(np.int64))
    return tuple(np.concatenate(x) if x else np.zeros(0, np.int64)
                 for x in out)


@pytest.mark.parametrize("k,w", [(15, 10), (16, 64), (5, 1), (15, 17),
                                 (11, 33), (16, 40)])
def test_kernel_sketch_model_matches_host_sketch(k, w):
    """seed_count's tiles (seed_count_model) emit what the host sketch
    (sketch_seq, which collect_seeds runs) emits: reads at store offsets
    off the 16-byte grid, with N codes, at lengths around k, k + w and
    the tile edges, on both sides of the lane split (S = 1 up to w = 16,
    S = 2 and 4 above)."""
    from minialign_tpu_torch.index.sketch import sketch
    rng = np.random.default_rng(1000 * k + w)
    T = seed_device.TILE
    lens = [0, 1, k - 1, k, k + 1, k + w - 1, k + w, k + w + 1, T - 1 + k,
            T + k, T + k + w, 2 * T + k - 1, 5000]
    store, offs = [], []
    at = 0
    for L in lens:
        gap = int(rng.integers(0, 40))
        store.append(rng.integers(0, 4, gap).astype(np.int8))
        r = rng.integers(0, 4, L).astype(np.int8)
        r[rng.random(L) < 0.02] = 4
        store.append(r)
        offs.append(at + gap)
        at += gap + L
    store = np.concatenate(store)
    for L, off in zip(lens, offs):
        read = store[off:off + L]
        want = sketch(np.asarray(read, np.int64) & 3, k, w)
        got = seed_count_model(store, off, L, k, w)
        for g, x, what in zip(got, want, ("hash", "pos", "strand")):
            np.testing.assert_array_equal(
                np.asarray(g, np.int64), np.asarray(x, np.int64),
                err_msg=f"{what} k={k} w={w} L={L} off={off}")
