"""The port's sharding (minialign_tpu_torch.parallel.shard and the D3
lookup's plain version, parallel.cuda_lookup) on the CPU against the
JAX package's minialign_tpu.parallel.shard on conftest's virtual
8-device CPU mesh: the shard tables array for array, the sharded lookup
on edge cases, the sharded fill, the sharded engine and the sharded
pipeline against the single-device ones, and the CLI's mesh branch
with make_mesh giving 8 CPU entries (the counterpart of the virtual
mesh).

The JAX package casts uint64 to uint32 unless jax_enable_x64 is on, so
tables with hashes past 2^32 go through its lookup under
jax.enable_x64(True); minimizer hashes of the default k = 15 fit in 32
bits and go through it as the CLI calls it."""

import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

import minialign_tpu.parallel.shard as jshard
from minialign_tpu.params import ScoreParams as JScoreParams
from minialign_tpu_torch import kbench
from minialign_tpu_torch import native as tnative
from minialign_tpu_torch.dp import band
from minialign_tpu_torch.extend import FillEngine
from minialign_tpu_torch.index.build import build_index
from minialign_tpu_torch.index.sketch import sketch
from minialign_tpu_torch.io import bseq
from minialign_tpu_torch.params import IndexParams, MapParams, ScoreParams
from minialign_tpu_torch.parallel import cuda_lookup, shard
from minialign_tpu_torch.pipeline import align_batch

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def python_seeding(monkeypatch):
    """The port's native library unloaded, as MINIALIGN_NO_NATIVE=1
    leaves it: seeding then calls the index's lookup (with the library,
    native.collect_seeds reads the keys directly and the sharded lookup
    is never called)."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)


def _tref():
    seqs = list(bseq.read_seqs(os.path.join(DATA, "tref.fa")))
    return [s.name for s in seqs], [s.codes for s in seqs]


def _table(kind):
    return kbench.lookup_table(kind, build_index, IndexParams)


# ---- the shard tables


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["tref", "empty", "high"])
def test_shard_index_arrays_equal(kind, n):
    keys, off = _table(kind)
    got = shard.shard_index_arrays(keys, off, n)
    want = jshard.shard_index_arrays(keys, off, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert got[0].shape == (n, -(-len(keys) // n) if len(keys) else 1)


# ---- D3's plain version against the JAX lookup


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("kind", kbench.LOOKUP_KINDS)
def test_lookup_plain_matches_jax(kind, n):
    """The port's sharded lookup (lookup_plain per shard, the sum as
    merge) over n CPU entries equals JAX make_sharded_lookup over the
    first n devices of the virtual mesh, on every key, misses, the pad
    value, and hashes below and above the table; the shards of unequal
    fill (K not a multiple of n) and K = 0 included."""
    keys, off = _table(kind)
    q = kbench.lookup_queries(keys)
    tabs = shard.shard_index_arrays(keys, off, n)
    st, cn = shard.make_sharded_lookup(shard.make_mesh(n, "cpu"))(*tabs, q)
    x64 = kind != "tref"          # hashes past 2^32: JAX needs 64 bits
    with jax.enable_x64(x64):
        jst, jcn = jshard.make_sharded_lookup(jshard.make_mesh(n))(
            *tabs, jax.numpy.asarray(q))
    assert st.dtype == cn.dtype == torch.int64
    assert np.array_equal(st.numpy(), np.asarray(jst, np.int64))
    assert np.array_equal(cn.numpy(), np.asarray(jcn, np.int64))
    # and the shards' own rows: a hit in exactly one shard
    pst, pcn = cuda_lookup.lookup_plain(*kbench.lookup_tensors(
        torch, tabs, q, "cpu"))
    assert pst.shape == (n, len(q))
    assert ((pcn > 0).sum(0) <= 1).all()
    assert torch.equal(pcn.sum(0), cn)


def test_lookup_takes_the_cpu_path_and_refuses_other_devices():
    keys, off = _table("high")
    *tabs, q = kbench.lookup_tensors(
        torch, shard.shard_index_arrays(keys, off, 2),
        kbench.lookup_queries(keys), "cpu")
    got = cuda_lookup.lookup(*tabs, q)
    want = cuda_lookup.lookup_plain(*tabs, q)
    assert all(map(torch.equal, got, want))
    with pytest.raises(ValueError, match="no lookup"):
        cuda_lookup.lookup(*(t.to("meta") for t in tabs), q.to("meta"))
    with pytest.raises(ValueError, match="int64"):
        cuda_lookup.lookup(tabs[0].int(), *tabs[1:], q)


@pytest.mark.parametrize("k", [15, 19])
def test_sharded_index_lookup_matches_mmindex(k):
    """ShardedIndex.lookup over 3 CPU entries equals MMIndex.lookup on a
    read's hashes and on misses; an empty query returns empty arrays;
    other attributes come from the index (bkt_off included)."""
    mi = build_index(IndexParams(k=k, w=10), *_tref())
    smi = shard.ShardedIndex(mi, shard.make_mesh(3, "cpu"))
    codes = _tref()[1][0]
    qh, _, _ = sketch(codes[1000:4000].astype(np.int64), k, 10)
    q = np.concatenate([qh, qh + np.uint64(1)])
    for got, want in zip(smi.lookup(q), mi.lookup(q)):
        assert np.array_equal(got, want)
    assert [x.shape for x in smi.lookup(np.zeros(0, np.uint64))] == [(0,)] * 2
    assert smi.bkt_off is mi.bkt_off and smi.names == mi.names


# ---- the sharded fill


def _fill_inputs(n, L=200, seed=3):
    rng = np.random.default_rng(seed)
    a = [rng.integers(0, 4, L).astype(np.int8) for _ in range(2 * n + 1)]
    b = [x.copy() if i % 2 else rng.integers(0, 4, L // 2).astype(np.int8)
         for i, x in enumerate(a)]
    return (*band.pad_codes(a), *band.pad_codes(b))


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_fill_matches_jax(n):
    """make_sharded_fill over n CPU entries against the JAX package's on
    the virtual mesh: max_score, max_i and max_j (B = 2n, as JAX's
    sharding takes an even split)."""
    ab, alen, bb, blen = (x[:2 * n] for x in _fill_inputs(n))
    got = shard.make_sharded_fill(ScoreParams(), 64, 20,
                                  shard.make_mesh(n, "cpu"))(ab, alen, bb,
                                                             blen)
    want = jshard.make_sharded_fill(JScoreParams(), 64, 20,
                                    jshard.make_mesh(n))(ab, alen, bb, blen)
    for f in ("max_score", "max_i", "max_j"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("trace", [False, True])
def test_sharded_fill_matches_unsharded(trace):
    """An uneven split (2n + 1 problems over n = 3) gives the unsharded
    fill's FillResult, and its trace buffers over the blocks each
    problem filled itself (the batched plain fill goes on stepping a
    problem that has ended while others run, so later blocks depend on
    the batch)."""
    args = [torch.from_numpy(x) for x in _fill_inputs(3)]
    p = ScoreParams()
    nb = band.max_blocks_for(args[1].numpy(), args[3].numpy())
    got = shard.make_sharded_fill(p, 32, nb, shard.make_mesh(3, "cpu"),
                                  trace)(*args)
    want = band.fill(p, 32, nb, trace, *args)
    rg, rw = (got[0], want[0]) if trace else (got, want)
    for f in rg._fields:
        assert torch.equal(getattr(rg, f), getattr(rw, f)), f
    if trace:
        own = (rg.n_steps // band.BLK).tolist()
        for f in got[1]._fields:
            g, w = getattr(got[1], f), getattr(want[1], f)
            assert g.shape == w.shape
            for k, nk in enumerate(own):
                assert torch.equal(g[k, :nk], w[k, :nk]), (f, k)


# ---- the sharded engine and pipeline


def _requests(seed=7):
    """Down and up requests on raw code arrays: related pairs, an
    unrelated one, an empty side."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(7):
        a = rng.integers(0, 4, int(rng.integers(50, 400))).astype(np.int8)
        b = a.copy() if i % 3 else rng.integers(0, 4, 120).astype(np.int8)
        if i == 5:
            b = np.zeros(0, np.int8)
        reqs.append(("up" if i % 2 else "down", a, b, (16, 32, 64)[i % 3]))
    return reqs


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_engine_run_matches_single(n):
    """ShardedFillEngine.run over n CPU entries (7 requests: contiguous
    blocks of 1-3, empty shards when n = 8) returns FillEngine.run's
    results in request order, traced ups included. It has no
    use_pallas, so align_batch sends it raw arrays and no duo."""
    reqs = _requests()
    p = MapParams().score
    eng = shard.ShardedFillEngine(p, shard.make_mesh(n, "cpu"))
    assert not hasattr(eng, "use_pallas") and eng.p is p
    got = eng.run(reqs)
    want = FillEngine(p, device="cpu").run(reqs)
    assert got == want
    assert sum(r[3] is not None for r in got) == 3


def _reads(n=4, seed=9):
    names, codes = _tref()
    g = codes[0]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        st = int(rng.integers(0, len(g) - 1200))
        s = g[st:st + int(rng.integers(800, 1200))].copy()
        r = rng.random(len(s))
        s = np.where(r < 0.04, rng.integers(0, 4, len(s)), s).astype(np.int8)
        out.append((3 - s)[::-1].copy() if rng.random() < 0.5 else s)
    return out


def test_align_batch_sharded_matches_align_batch(python_seeding,
                                                 monkeypatch):
    """align_batch_sharded over 2 CPU entries with the native seeding
    off (so seeding calls ShardedIndex.lookup) gives align_batch's
    records on the single engine, Reg for Reg."""
    mp = MapParams()
    mi = build_index(IndexParams(), *_tref())
    reads = _reads()
    calls = []
    lookup = shard.ShardedIndex.lookup

    def counted(self, h):
        calls.append(len(h))
        return lookup(self, h)
    monkeypatch.setattr(shard.ShardedIndex, "lookup", counted)
    got = shard.align_batch_sharded(mp, mi, reads, shard.make_mesh(2, "cpu"))
    assert calls
    want = align_batch(mp, mi, reads, FillEngine(mp.score, device="cpu"))
    assert got == want
    assert sum(r is not None for r in got) == len(reads)


# ---- the CLI's mesh branch


def _cli(args, monkeypatch):
    from minialign_tpu_torch import cli
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    assert cli.main(args) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def reads_fq(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "reads.fq"
    with open(path, "w") as f:
        for i, s in enumerate(_reads(3, seed=4)):
            f.write(f"@m{i}\n{''.join('ACGT'[c] for c in s)}\n+\n"
                    f"{'I' * len(s)}\n")
    return str(path)


@pytest.mark.parametrize("shard_env", ["1", "", "0"])
def test_cli_mesh_branch(shard_env, reads_fq, monkeypatch):
    """make_mesh giving 8 CPU entries (the virtual mesh's counterpart):
    unset or any value but 0, MINIALIGN_SHARD maps through
    ShardedFillEngine and ShardedIndex, 0 through one FillEngine, and the
    output is the same, @PG included."""
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("MINIALIGN_PROC_WORKERS", raising=False)
    monkeypatch.setattr(shard, "make_mesh",
                        lambda n_devices=None, device="cuda":
                        [torch.device("cpu")] * 8)
    built = []
    init = shard.ShardedFillEngine.__init__

    def record(self, score, mesh, batch=None):
        built.append(len(mesh))
        init(self, score, mesh, batch)
    monkeypatch.setattr(shard.ShardedFillEngine, "__init__", record)
    args = ["-t1", os.path.join(DATA, "tref.fa"), reads_fq]
    monkeypatch.setenv("MINIALIGN_SHARD", shard_env)
    got = _cli(args, monkeypatch)
    assert built == ([] if shard_env == "0" else [8])
    monkeypatch.setenv("MINIALIGN_SHARD", "0")
    assert got == _cli(args, monkeypatch)
    assert len([x for x in got.splitlines() if not x.startswith("@")]) >= 3


def test_make_mesh_and_blocks():
    assert shard.make_mesh(4, "cpu") == [torch.device("cpu")] * 4
    assert shard.make_mesh(device="cpu") == [torch.device("cpu")]
    assert shard.make_mesh(device="cuda") == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    assert shard._blocks(7, 3) == [slice(0, 3), slice(3, 6), slice(6, 7)]
    assert shard._blocks(2, 4) == [slice(0, 1), slice(1, 2), slice(2, 2),
                                   slice(2, 2)]
    assert shard._groups(["cpu", "cpu"]) == [(torch.device("cpu"), [0, 1])]
    # the JAX mesh splits an even problem axis the same way
    mesh = jshard.make_mesh(4)
    x = jax.device_put(np.arange(8), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("dp")))
    spans = sorted((s.index[0].start, s.index[0].stop)
                   for s in x.addressable_shards)
    assert spans == [(sl.start, sl.stop) for sl in shard._blocks(8, 4)]
