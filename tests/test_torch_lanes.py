"""A read's chains on different target sequences extended in the same
engine rounds (extend.plan_lanes, pipeline._serve), on the CPU engine.

Five references of 2.0-3.2 kb share a 600-base segment at the same
offset, so a read from it chains on five targets; a 500-base sixth
reference lies in no other. Held: the Regs and the rlen left behind equal
the JAX package's align_batch; the engine sees a laned read's requests
side by side in one round, and its passes are answered from the memo; a
forced disagreement between the lanes and the sequential loop still gives
the sequential output, its misses sent to the engine; a stale-rlen replay
of a laned read sends only its misses; a one-target read builds no lane."""

import numpy as np
import pytest
import torch

from minialign_tpu.index.build import build_index
from minialign_tpu.params import IndexParams, MapParams
from minialign_tpu_torch import extend, pipeline, stats
from minialign_tpu_torch import params as tparams
from minialign_tpu_torch.extend import FillEngine, revcomp_codes
from minialign_tpu_torch.index.build import build_index as tbuild_index
from test_torch_pipeline import _same


@pytest.fixture(autouse=True)
def one_thread_recorder_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    stats.stop()
    stats.reset()
    yield
    stats.stop()
    stats.reset()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refs():
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 4, 600).astype(np.int8)
    seqs = [np.concatenate([rng.integers(0, 4, 800), shared,
                            rng.integers(0, 4, 600 + 300 * k)])
            .astype(np.int8) for k in range(5)]
    seqs.append(rng.integers(0, 4, 500).astype(np.int8))
    names = [f"r{k}" for k in range(5)] + ["short"]
    return (shared, seqs, build_index(IndexParams(), names, seqs),
            tbuild_index(tparams.IndexParams(), names, seqs))


def _engine(rounds: list):
    """A CPU engine that keeps the requests of each of its rounds."""
    eng = FillEngine(tparams.MapParams().score, batch=64, device="cpu")
    run = eng.run

    def kept(reqs):
        rounds.append(list(reqs))
        return run(reqs)
    eng.run = kept
    return eng


def _qidx(req) -> int:
    return req[2][1]          # b = ("q", qidx, strand, start)


def _mapped(mi, reads, eng, tbuf):
    """align_batch with the recorder on; its Regs and counters."""
    stats.start()
    try:
        regs = pipeline.align_batch(tparams.MapParams(), mi, reads, eng,
                                    tbuf=tbuf)
        return regs, stats.read()["counters"]
    finally:
        stats.stop()
        stats.reset()


def test_laned_reads_match_jax_side_by_side_from_the_memo(refs):
    shared, _, mi, tmi = refs
    reads = [shared[50:450].copy(), revcomp_codes(shared[100:500])]
    rounds = []
    tb, tbj = {"rlen": 0}, {"rlen": 0}
    stats.start()
    try:
        got = _same(MapParams(), mi, tmi, reads, _engine(rounds), tbuf=tb,
                    tbuf_jax=tbj)
        c = stats.read()["counters"]
    finally:
        stats.stop()
    assert tb == tbj
    assert sorted(a.aln.rid for a in got[0].alns) == [0, 1, 2, 3, 4]
    # the first round holds every lane of both reads
    assert all(sum(_qidx(r) == i for r in rounds[0]) >= 3 for i in (0, 1))
    assert c["pipeline.lane_reads"] == 2
    assert c["pipeline.lane_hits"] == c["pipeline.ext_reqs"] > 0
    assert c["pipeline.lane_unused"] == 0
    # the passes sent nothing: the engine saw the lanes' requests alone
    assert sum(len(r) for r in rounds) == c["pipeline.lane_hits"]


def test_a_wrong_lane_guess_gives_the_sequential_output(refs, monkeypatch):
    """The lanes get a wrong first-root test (a stale rlen of 0 fires it,
    where the true one, 5,000, does not), so the sequential loop asks for
    what the lanes did not. Those misses go to the engine, the lanes'
    unread results are counted, and the output is that of the loop with
    no lanes."""
    shared, _, _, tmi = refs
    reads = [revcomp_codes(shared[100:500])]
    plan = extend.plan_lanes

    def wrong(mp, mi, q, seeds, chains, S, tbuf, rec):
        return plan(mp, mi, q, seeds, chains, S, {"rlen": 0, "spec": False},
                    rec)
    monkeypatch.setattr(extend, "plan_lanes", wrong)
    rounds = []
    got, c = _mapped(tmi, reads, _engine(rounds), {"rlen": 5000})
    monkeypatch.setattr(extend, "plan_lanes", lambda *a: [])
    want, c0 = _mapped(tmi, reads, _engine([]), {"rlen": 5000})
    assert c0["pipeline.lane_reads"] == 0 and c0["pipeline.lane_hits"] == 0
    assert c["pipeline.lane_reads"] == 1
    misses = c["pipeline.ext_reqs"] - c["pipeline.lane_hits"]
    assert misses > 0 and c["pipeline.lane_unused"] > 0
    # each lane result made once, each miss sent once
    assert sum(len(r) for r in rounds) == misses + c["pipeline.lane_hits"] \
        + c["pipeline.lane_unused"]
    assert [[(a.mapq, a.aid, a.aln) for a in r.alns] for r in got] == \
        [[(a.mapq, a.aid, a.aln) for a in r.alns] for r in want]


def test_a_replayed_laned_read_sends_only_its_misses(refs, monkeypatch):
    """Read 0 maps to the short reference and leaves rlen 500 behind; read
    1's first root lies past 500 on its 2-3 kb targets, so its guess (its
    own target's length) is wrong and it replays. The replay's requests
    that its first pass or lanes made come from the memo; the engine sees
    only the rest. Regs and rlen as the JAX package's."""
    shared, seqs, mi, tmi = refs
    reads = [seqs[5][50:450].copy(), revcomp_codes(shared[100:500])]
    replay_reqs = []
    orig = pipeline.extend_read

    def tagged(g):
        try:
            req = g.send(None)
            while True:
                replay_reqs.append(req)
                req = g.send((yield req))
        except StopIteration as e:
            return e.value

    def extend_read(*args, tbuf=None, **kw):
        g = orig(*args, tbuf=tbuf, **kw)
        return tagged(g) if args[3] > 0 and not tbuf["spec"] else g
    monkeypatch.setattr(pipeline, "extend_read", extend_read)
    rounds = []
    tb, tbj = {"rlen": 0}, {"rlen": 0}
    stats.start()
    try:
        _same(MapParams(), mi, tmi, reads, _engine(rounds), tbuf=tb,
              tbuf_jax=tbj)
        c = stats.read()["counters"]
    finally:
        stats.stop()
    assert tb == tbj and c["pipeline.replays"] == 1
    sent = sum(any(r is x for x in replay_reqs) for rs in rounds for r in rs)
    assert 0 < sent < len(replay_reqs)
    assert c["pipeline.ext_reqs"] - c["pipeline.lane_hits"] == 1 + sent


def test_a_one_target_read_builds_no_lane(refs):
    _, seqs, _, tmi = refs
    reads = [seqs[3][2000:2400].copy(), seqs[5][20:420].copy()]
    rounds = []
    regs, c = _mapped(tmi, reads, _engine(rounds), {"rlen": 0})
    assert all(r is not None for r in regs)
    assert c["pipeline.lane_reads"] == 0 and c["pipeline.lane_hits"] == 0
    assert c["pipeline.ext_reqs"] == sum(len(r) for r in rounds) > 0
