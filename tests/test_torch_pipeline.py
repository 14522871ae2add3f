"""The port's align_batch (FillEngine on the CPU: plain gather, fill and
walk) against the JAX package's align_batch, on tests/test_pipeline.py's
cases: every Reg and Aln field equal."""

import dataclasses

import numpy as np
import pytest
import torch

from minialign_tpu.extend import revcomp_codes
from minialign_tpu.index.build import build_index
from minialign_tpu.params import IndexParams, MapParams
from minialign_tpu.pipeline import align_batch as jax_align_batch
from minialign_tpu_torch import params as tparams
from minialign_tpu_torch.extend import FillEngine
from minialign_tpu_torch.index.build import build_index as tbuild_index
from minialign_tpu_torch.pipeline import align_batch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain fill and walk run thousands of tiny ops, which gain
    nothing from intra-op threads; with several pytest workers on the
    machine those threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(42)
    return rng.integers(0, 4, 5000).astype(np.int8)


@pytest.fixture(scope="module")
def index(genome):
    return build_index(IndexParams(), ["chr_t"], [genome])


@pytest.fixture(scope="module")
def tindex(genome):
    return tbuild_index(tparams.IndexParams(), ["chr_t"], [genome])


@pytest.fixture(scope="module")
def engine():
    return FillEngine(tparams.MapParams().score, batch=8, device="cpu")


def _mutate(rng, s, err=0.08):
    out = []
    for ch in s:
        r = rng.random()
        if r < err * 0.5:
            out.append(rng.integers(0, 4))
        elif r < err * 0.75:
            out.append(rng.integers(0, 4))
            out.append(ch)
        elif r < err:
            pass
        else:
            out.append(ch)
    return np.asarray(out, np.int8)


def _same(mp, index, tindex, reads, engine, tbuf=None, tbuf_jax=None):
    """The port (its own params and index) against the JAX package."""
    got = align_batch(tparams.from_fields(mp), tindex, reads, engine,
                      tbuf=tbuf)
    want = jax_align_batch(mp, index, reads, tbuf=tbuf_jax)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), k
        if w is None:
            continue
        assert g.n_uniq == w.n_uniq, k
        assert len(g.alns) == len(w.alns), k
        for ga, wa in zip(g.alns, w.alns):
            assert (ga.mapq, ga.aid) == (wa.mapq, wa.aid), k
            # the two packages define their own Aln/Seg classes
            assert dataclasses.asdict(ga.aln) == dataclasses.asdict(wa.aln), k
    return got


def _cases(genome):
    rng = np.random.default_rng(7)
    reads = [genome[1000:2500].copy(), revcomp_codes(genome[1000:2500]),
             rng.integers(0, 4, 1000).astype(np.int8),
             np.zeros(10, np.int8)]
    for _ in range(6):
        st = int(rng.integers(0, 3000))
        r = _mutate(rng, genome[st:st + int(rng.integers(800, 2000))])
        reads.append(revcomp_codes(r) if rng.random() < 0.5 else r)
    return reads


@pytest.mark.parametrize("case", ["perfect", "reverse", "unmappable",
                                  "short", "mutated"])
def test_align_batch_matches_jax(case, index, tindex, genome, engine):
    reads = _cases(genome)
    pick = {"perfect": [0], "reverse": [1], "unmappable": [2],
            "short": [3], "mutated": list(range(4, 10))}[case]
    mp = MapParams()
    got = _same(mp, index, tindex, [reads[i] for i in pick], engine)
    if case in ("perfect", "reverse"):
        a = got[0].alns[0].aln
        assert (a.as0, a.ae, a.bs0, a.be) == (1000, 2500, 0, 1500)


def test_host_built_requests_match_jax(index, tindex, genome, engine,
                                      monkeypatch):
    """MINIALIGN_DEVICE_SEQS=0: align_batch sends raw code arrays instead
    of store slices; the engine uploads them and must agree all the
    same."""
    monkeypatch.setenv("MINIALIGN_DEVICE_SEQS", "0")
    reads = _cases(genome)
    _same(MapParams(), index, tindex, [reads[1]] + reads[4:7], engine)


def test_stale_rlen_tbuf_matches_jax(index, tindex, genome, engine):
    """The thread-buffer's stale rlen (PARITY.md item 8) is replayed the
    same way, and left behind the same."""
    reads = [genome[1000:2500].copy(), genome[200:1400].copy()]
    tb, tbj = {"rlen": 0}, {"rlen": 0}
    _same(MapParams(), index, tindex, reads, engine, tbuf=tb,
          tbuf_jax=tbj)
    assert tb == tbj and tb["rlen"] == len(genome)
