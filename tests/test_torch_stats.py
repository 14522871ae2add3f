"""The port's span and counter recorder (minialign_tpu_torch/stats.py) and
the spans and counters that the mapping path records with it, on the CPU
engine: align_batch yields every pipeline and engine span and its two
counters, children inside their parents and a parent's time equal to its
self time and its children's; off, nothing is recorded and the recorder
allocates nothing; on and off give the same Regs and SAM bytes; two
scheduler threads keep a stack each; a torch.profiler turns it on and
carries its clock anchors; MINIALIGN_STATS prints the launch, span and
counter lines at exit, the lane counters among them."""

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest
import torch

from minialign_tpu_torch import stats
from minialign_tpu_torch.extend import FillEngine, revcomp_codes
from minialign_tpu_torch.index.build import build_index
from minialign_tpu_torch.io import bseq
from minialign_tpu_torch.io.sam import SamWriter
from minialign_tpu_torch.params import IndexParams, MapParams
from minialign_tpu_torch.pipeline import align_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PIPELINE_SPANS = {"pipeline.seed", "pipeline.chain", "pipeline.extend",
                  "pipeline.post"}
ENGINE_SPANS = {"engine.submit", "engine.wait", "engine.harvest"}


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    stats.stop()
    stats.reset()
    yield
    stats.stop()
    stats.reset()
    torch.set_num_threads(n)


def _mutate(rng, s, err=0.05):
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
def two_refs():
    """Two references of different lengths, so that the second read's
    speculative first-root bounds test (against its own reference's
    length) disagrees with the true one (the first read's): one replay."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, 3000).astype(np.int8)
    b = rng.integers(0, 4, 9000).astype(np.int8)
    mi = build_index(IndexParams(), ["ra", "rb"], [a, b])
    reads = [a[500:900].copy(), b[5000:5400].copy(),
             revcomp_codes(_mutate(rng, b[7000:7400])), a[100:500].copy(),
             rng.integers(0, 4, 300).astype(np.int8)]
    return mi, reads


def _map(mi, reads, on: bool):
    """align_batch and the SAM records of its reads; the recorder on or
    off around both."""
    mp = MapParams()
    eng = FillEngine(mp.score, device="cpu")
    if on:
        stats.start()
    regs = align_batch(mp, mi, reads, eng, base_qid=0, tbuf={"rlen": 0})
    out = io.StringIO()
    wr = SamWriter(out)
    for i, (codes, reg) in enumerate(zip(reads, regs)):
        seq = bseq.Seq(name=f"r{i}", comment="", codes=codes, qual=b"")
        wr.mapped(mi.names, mi.lens, mi.codes, seq, reg)
    stats.stop()
    return regs, out.getvalue()


@pytest.fixture(scope="module")
def mapped(two_refs):
    mi, reads = two_refs
    stats.stop()
    stats.reset()
    off = _map(mi, reads, False)
    on = _map(mi, reads, True)
    rec = stats.read()
    stats.reset()
    return off, on, rec


def _check_nesting(rec):
    """Children inside their parents, on the parent's thread, one deeper;
    spans with the same parent on one thread do not overlap."""
    iv = rec["intervals"]
    kids: dict = {}
    for j, (name, a, b, self_ns, tid, par, depth, _, _) in enumerate(iv):
        assert a <= b and self_ns >= 0, iv[j]
        if par >= 0:
            p = iv[par]
            assert p[1] <= a and b <= p[2], (iv[j], p)
            assert p[4] == tid and p[6] + 1 == depth
        else:
            assert depth == 0
        kids.setdefault((tid, par), []).append((a, b))
    for sibs in kids.values():
        sibs.sort()
        for (_, b0), (a1, _) in zip(sibs, sibs[1:]):
            assert b0 <= a1
    return kids


def test_align_batch_records_every_pipeline_and_engine_span(mapped):
    _, _, rec = mapped
    assert set(rec["spans"]) == PIPELINE_SPANS | ENGINE_SPANS | {"io.format"}
    assert rec["counters"]["pipeline.reads"] == 5
    assert rec["counters"]["pipeline.replays"] == 1
    assert rec["counters"]["engine.rounds"] >= 2
    assert rec["spans"]["io.format"]["count"] == 5
    assert rec["launch_shapes"] and all(k == "duo" for k, *_ in
                                        rec["launch_shapes"])
    iv = rec["intervals"]
    by = {n: [x for x in iv if x[0] == n] for n in rec["spans"]}
    # seeding and chaining belong to their reads; the engine's spans sit
    # inside the pipeline's; a wait inside a harvest
    assert {x[8] for x in by["pipeline.seed"]} == {0, 1, 2, 3, 4}
    assert all(iv[x[5]][0] == "pipeline.extend" for x in
               by["pipeline.seed"] + by["pipeline.chain"]
               + by["engine.harvest"])
    assert all(iv[x[5]][0] == "engine.harvest" for x in by["engine.wait"])
    # the replay's extension runs inside the stale-rlen pass
    assert any(iv[x[5]][0] == "pipeline.post" for x in
               by["pipeline.extend"])
    assert all(x[5] == -1 for x in by["io.format"] + by["pipeline.post"])


def test_children_inside_parents_and_times_add_up(mapped):
    _, _, rec = mapped
    iv = rec["intervals"]
    _check_nesting(rec)
    child = [0] * len(iv)
    for x in iv:
        if x[5] >= 0:
            child[x[5]] += x[2] - x[1]
    for j, x in enumerate(iv):
        assert x[2] - x[1] == x[3] + child[j], x
    for name, s in rec["spans"].items():
        n = [x for x in iv if x[0] == name]
        assert s["count"] == len(n)
        assert s["total_s"] == pytest.approx(sum(x[2] - x[1] for x in n)
                                             * 1e-9)
        assert 0 <= s["self_s"] <= s["total_s"] + 1e-12


def test_regs_and_sam_bytes_equal_on_and_off(mapped):
    (regs_off, sam_off), (regs_on, sam_on), _ = mapped
    assert len(regs_off) == len(regs_on) == 5
    for a, b in zip(regs_off, regs_on):
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert sam_on == sam_off and sam_off.count("\n") >= 5


def test_off_records_nothing_and_allocates_nothing(two_refs):
    mi, reads = two_refs
    mp = MapParams()
    eng = FillEngine(mp.score, device="cpu")
    assert not stats.ON
    tracemalloc.start()
    try:
        regs = align_batch(mp, mi, reads[:2], eng, base_qid=0,
                           tbuf={"rlen": 0})
        wr = SamWriter(io.StringIO())
        for i, (codes, reg) in enumerate(zip(reads, regs)):
            wr.mapped(mi.names, mi.lens, mi.codes, bseq.Seq(
                name=f"r{i}", comment="", codes=codes, qual=b""), reg)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = snap.filter_traces([tracemalloc.Filter(True, stats.__file__)])
    assert mine.statistics("lineno") == []
    assert regs[0] is not None
    r = stats.read()
    assert r["spans"] == {} and r["counters"] == {}
    assert r["intervals"] == [] and r["launch_shapes"] == []
    assert stats._threads == []


def test_two_scheduler_threads_keep_a_stack_each(monkeypatch):
    monkeypatch.setenv("MINIALIGN_SCHED_WORKERS", "2")
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 20000).astype(np.int8)
    reads = []
    for i in range(64):
        st = int(rng.integers(0, 19000))
        r = _mutate(rng, g[st:st + 200])
        reads.append(revcomp_codes(r) if i % 2 else r)
    mi = build_index(IndexParams(), ["c"], [g])
    mp = MapParams()
    stats.start()
    regs = align_batch(mp, mi, reads, FillEngine(mp.score, device="cpu"),
                       base_qid=100, tbuf={"rlen": 0})
    stats.stop()
    assert sum(r is not None for r in regs) >= 60
    rec = stats.read()
    kids = _check_nesting(rec)
    iv = rec["intervals"]
    tids = {x[4] for x in iv}
    assert len(tids) == 2
    for tid in tids:
        top = {x[0] for x in iv if x[4] == tid and x[5] == -1}
        assert "pipeline.extend" in top, top
        # each thread drives its share's rounds through the engine (the
        # reads are seeded by the first send loop, on the calling thread)
        assert {x[0] for x in iv if x[4] == tid} >= {
            "engine.submit", "engine.harvest", "engine.wait"}
        # every top-level span of the thread, one after the other
        assert len(kids[(tid, -1)]) >= 2
    assert {x[7] for x in iv if x[0] == "pipeline.extend"} == {100}
    assert rec["counters"]["pipeline.reads"] == 64
    assert rec["spans"]["pipeline.seed"]["count"] >= 64


def test_manual_spans_self_time_filter_and_reset():
    stats.start()
    outer = stats.begin("a", 7, 8)
    inner = stats.begin("b")
    stats.end(inner)
    left_open = stats.begin("c")
    stats.end(outer)                    # closes c's stack entry too
    late = stats.begin("d")
    stats.end(late)
    stats.add("n", 2)
    stats.add("n")
    rec = stats.read()
    assert set(rec["spans"]) == {"a", "b", "d"}      # c never closed
    a, b, d = (next(x for x in rec["intervals"] if x[0] == k)
               for k in "abd")
    assert a[5] == -1 and b[5] == rec["intervals"].index(a)
    assert (a[7], a[8], b[7], b[8]) == (7, 8, -1, -1)
    assert a[3] == (a[2] - a[1]) - (b[2] - b[1])
    assert d[5] == -1 and d[6] == 0 and left_open == 2
    assert rec["counters"] == {"n": 3}
    since = stats.read(since_ns=d[1])
    assert [x[0] for x in since["intervals"]] == ["d"]
    tok = stats.begin("e")
    stats.reset()
    stats.end(tok)                       # void after reset
    assert stats.read()["intervals"] == []


def test_read_batches_one_parse_span_a_batch_none_open_at_yield(tmp_path):
    fq = tmp_path / "r.fq"
    rng = np.random.default_rng(1)
    with open(fq, "w") as f:
        for i in range(10):
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, 300))
            f.write(f"@q{i}\n{s}\n+\n{'I' * 300}\n")
    stats.start()
    n = 0
    for batch in bseq.read_batches(str(fq), batch_size=1000):
        assert stats._local.t.stack == []
        n += 1
    stats.stop()
    assert n == 3
    rec = stats.read()
    assert rec["spans"]["io.parse"]["count"] == 3


def test_build_index_sketch_and_sort_spans():
    g = np.random.default_rng(2).integers(0, 4, 30000).astype(np.int8)
    stats.start()
    build_index(IndexParams(), ["c"], [g])
    stats.stop()
    rec = stats.read()
    assert rec["spans"]["index.sketch"]["count"] == 1
    assert rec["spans"]["index.sort"]["count"] == 1
    sk, so = (next(x for x in rec["intervals"] if x[0] == k)
              for k in ("index.sketch", "index.sort"))
    assert sk[2] <= so[1]


def test_a_profiler_turns_it_on_and_carries_its_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    stats.tick()
    assert not stats.ON
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats.tick()
        assert stats.ON
        sp = stats.begin("io.parse")
        stats.end(sp)
        stats.tick()
    stats.tick()
    assert not stats.ON
    rec = stats.read()
    assert rec["spans"]["io.parse"]["count"] == 1
    assert len(rec["anchors"]) == 2
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    got = [int(e["name"].split()[1]) for e in ev
           if str(e.get("name", "")).startswith("minialign.clock ")]
    assert got == rec["anchors"]
    iv = rec["intervals"][0]
    assert got[0] <= iv[1] <= iv[2] <= got[1]


CHILD = r"""
import io, sys
import numpy as np
from minialign_tpu_torch import stats
from minialign_tpu_torch.extend import FillEngine
from minialign_tpu_torch.index.build import build_index
from minialign_tpu_torch.io import bseq
from minialign_tpu_torch.io.sam import SamWriter
from minialign_tpu_torch.params import IndexParams, MapParams
from minialign_tpu_torch.pipeline import align_batch
assert stats.ON
rng = np.random.default_rng(3)
g = rng.integers(0, 4, 8000).astype(np.int8)
mi = build_index(IndexParams(), ["c"], [g])
path = sys.argv[1]
with open(path, "w") as f:
    for i, st in enumerate((100, 2000, 5000)):
        s = "".join("ACGT"[c] for c in g[st:st + 400])
        f.write(f"@q{i}\n{s}\n+\n{'I' * 400}\n")
mp = MapParams()
eng = FillEngine(mp.score, device="cpu")
wr = SamWriter(io.StringIO())
for batch in bseq.read_batches(path, batch_size=10**6):
    regs = align_batch(mp, mi, [s.codes for s in batch], eng)
    for s, reg in zip(batch, regs):
        wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
"""


def test_minialign_stats_prints_launch_span_and_counter_lines(tmp_path):
    env = dict(os.environ, MINIALIGN_STATS="1", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", CHILD,
                        str(tmp_path / "q.fq")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [x for x in r.stderr.splitlines() if x.startswith("[stats] ")]
    launch = [x for x in lines
              if re.fullmatch(r"\[stats\] duo nreal=\d+ B=\d+ x\d+", x)]
    spans = {m[1]: (int(m[2]), float(m[3]), float(m[4])) for m in (
        re.fullmatch(r"\[stats\] span (\S+) n=(\d+) total_s=([\d.]+) "
                     r"self_s=([\d.]+)", x) for x in lines) if m}
    counters = {m[1]: int(m[2]) for m in (
        re.fullmatch(r"\[stats\] counter (\S+) (\d+)", x) for x in lines)
        if m}
    assert launch and len(launch) + len(spans) + len(counters) == len(lines)
    # launch lines first, then spans, then counters
    assert lines[:len(launch)] == launch
    assert set(spans) == (PIPELINE_SPANS | ENGINE_SPANS
                          | {"io.parse", "io.format", "index.sketch",
                             "index.sort"})
    assert spans["io.parse"][0] == 1 and spans["io.format"][0] == 3
    assert all(0 <= s <= t for _, t, s in spans.values())
    assert counters["pipeline.reads"] == 3
    assert counters["pipeline.replays"] == 0
    assert counters["engine.rounds"] >= 1
    # one reference: no read is laned, and every request goes to the engine
    assert counters["pipeline.ext_reqs"] >= 3
    assert counters["pipeline.lane_reads"] == 0
    assert counters["pipeline.lane_hits"] == 0
    assert counters["pipeline.lane_unused"] == 0
