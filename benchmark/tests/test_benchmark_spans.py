"""The program's spans on a device trace (spans.py) and the metrics that
read them (program.py, metrics/): a hand-made chrome trace whose clock
drifts against perf_counter_ns is mapped by its two anchors, and the
idle time goes to the innermost program span in progress, else the
harness's, else none_of_these; the tiny CPU cell, traced, reads every
metric of the program's spans and counters as a number; a program
without the recorder reads none of them and raises nothing."""

import json
import subprocess
import sys

import pytest

from benchmark import program, spans
from benchmark.tests import tiny

ROOT = tiny.HERE.rsplit("/", 1)[0]

NEW = ("io.parse_ms_per_mbase", "io.format_ms_per_mbase",
       "pipeline.seed_ms_per_mbase", "pipeline.chain_ms_per_mbase",
       "pipeline.extend_ms_per_mbase", "pipeline.post_ms_per_mbase",
       "pipeline.replay_share", "engine.submit_ms_per_mbase",
       "engine.wait_ms_per_mbase", "engine.harvest_ms_per_mbase",
       "engine.rounds_per_mbase")

# trace us = A + B * perf_counter_ns: the trace's clock runs 0.1% fast
A, B = 5_000.0, 1.001e-3


def _tr(ns: float) -> float:
    return A + B * ns


def _x(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(tmp_path):
    """A window of 10 ms from perf 1e6 ns; kernels and one copy; the
    program's two pipeline.extend spans, an engine.wait in the first; the
    harness's io.read, pipeline.align_batch and io.write around them."""
    ev = [_x("bench.window", _tr(1e6), B * 1e7, "user_annotation")]
    for ns in (1_000_000, 10_900_000):          # the two anchors
        ev.append(_x(f"minialign.clock {ns}", _tr(ns), 3.0,
                     "user_annotation"))
    ev.append(_x("Memcpy_DtoH (Device -> Pinned)", _tr(4_500_000), 10.0,
                 "gpu_memcpy"))
    for a, b in ((1.0, 2.0), (3.0, 3.5), (4.0, 4.4), (6.0, 6.5),
                 (8.0, 8.5), (9.9, 10.0)):
        ev.append(_x("fill_kernel", _tr(a * 1e6), B * (b - a) * 1e6,
                     "kernel"))
    path = tmp_path / "t.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    # stats.read()'s intervals: (name, t0, t1, self, thread, parent,
    # depth, batch, qid)
    rec = {"anchors": [1_000_000, 10_900_000], "counters": {"x": 1},
           "spans": {},
           "intervals": [
               ("pipeline.extend", 2_000_000, 5_000_000, 0, 1, -1, 0, 0, -1),
               ("engine.wait", 4_400_000, 4_520_000, 0, 1, 0, 1, 0, -1),
               ("pipeline.extend", 6_500_000, 8_000_000, 0, 1, -1, 0, 0,
                -1)]}
    harness = {"engine.run": [(4_300_000, 4_600_000)],
               "pipeline.align_batch": [(2_000_000, 8_000_000)],
               "io.write": [(8_000_000, 10_000_000)],
               "io.read": [(1_000_000, 2_000_000)]}
    return str(path), rec, harness


def test_clock_line_from_two_drifted_anchors(tmp_path):
    path, _, _ = _trace(tmp_path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    a, b = spans.clock_line(ev)
    assert b == pytest.approx(B, rel=1e-12)
    assert a == pytest.approx(A, abs=1e-6)
    assert spans.clock_line(ev[:2]) is None      # one anchor: no line


def test_idle_gaps_go_to_the_innermost_program_span(tmp_path):
    path, rec, harness = _trace(tmp_path)
    r = spans.report(path, 1_000_000, harness, rec)
    g = dict(r["idle_gaps"])
    ms = B * 1e6 * 1e-6  # trace seconds a perf millisecond
    copy_end = 4.5 + 10.0 / B * 1e-6             # perf ms
    # each gap split by the innermost program span; the parts with none
    # by the harness's span at their middle
    assert g == pytest.approx({
        "pipeline.extend": (1.0 + 0.5 + (5.0 - 4.52) + 1.5) * ms,
        "engine.wait": (0.1 + 4.52 - copy_end) * ms,   # 4.4-4.5, -4.52
        "pipeline.align_batch": 1.0 * ms,              # 5-6: no span
        "io.write": 1.4 * ms,                          # 8.5-9.9
        "none_of_these": 1.0 * ms})                    # 10-11
    assert r["busy_s"] == pytest.approx((3.0 + copy_end - 4.5) * ms)
    assert r["window_s"] == pytest.approx(10 * ms)
    idle = 10.0 - (3.0 + copy_end - 4.5)
    assert r["idle_coarse_share"] == pytest.approx((1.0 + 1.4 + 1.0) / idle)
    assert r["clock"]["us_per_ns"] == pytest.approx(B)
    assert r["clock"]["offset_vs_window_tie_us"] == pytest.approx(
        0.0, abs=1e-6)
    # the copy ends 10 us of trace after 4.5 ms, the wait at 4.52 ms
    lag = r["wait_lag"]
    assert (lag["matched"], lag["waits"], lag["first_5s_n"]) == (1, 1, 1)
    assert lag["first_5s_median_us"] == pytest.approx(B * 20_000 - 10.0)
    cov = r["coverage"]
    assert cov["align_batch_by_program"] == pytest.approx(4.5 / 6.0)
    assert cov["engine_run_by_engine"] == pytest.approx(0.12 / 0.3)
    assert cov["io_by_parse_format"] == 0.0


def test_innermost_timeline_across_threads():
    # (name, t0, t1, thread, depth)
    sp = [("a", 0, 10, 1, 0), ("b", 2, 4, 1, 1), ("c", 3, 6, 2, 0),
          ("d", 8, 12, 2, 1)]
    assert spans.innermost(sp) == [[0, 2, "a"], [2, 4, "b"], [4, 6, "c"],
                                   [6, 8, "a"], [8, 12, "d"]]


def test_covered_counts_each_outer_once():
    assert spans.covered([(0, 10), (5, 20)], [(2, 4), (3, 6), (18, 30)]) \
        == pytest.approx((4 + 2) / 20)
    assert spans.covered([(0, 10)], []) == 0.0


def test_no_recorder_reads_nothing_and_raises_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "minialign_tpu_torch.stats", None)
    program._memo.clear()

    class W:
        t0, t1, bases = 1.0, 2.0, 10**6
    ctx = {"traced": True, "window": W(), "trace": None, "counters": {}}
    from benchmark import run
    for name in NEW:
        assert run.read_metric(name, ctx) is None


def test_tiny_traced_cell_reads_every_program_metric(tmp_path):
    """The tiny cell on the CPU, traced, with the recorder told that a
    profiler records (the harness runs its own only on the card; a CPU
    profiler around the plain fill's many small ops takes minutes): every
    metric of the program's spans and counters is a number."""
    code = (
        "import json\n"
        "from minialign_tpu_torch import stats\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import run\n"
        "stats._profiling = lambda: True\n"
        f"c, j, r = tiny.run({str(tmp_path)!r}, traced=True)\n"
        f"m = {{n: run.read_metric(n, r['ctx']) for n in {NEW!r}}}\n"
        "print(json.dumps({'checks': c, 'judged': j, 'metrics': m}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["judged"] >= 4
    assert all(v == 0 for v in out["checks"].values()), out["checks"]
    m = out["metrics"]
    assert all(isinstance(m[n], float) for n in NEW), m
    assert all(m[n] > 0 for n in NEW if n != "pipeline.replay_share"), m
    assert 0 <= m["pipeline.replay_share"] <= 100
