"""trace.read on the hand-made trace of test_benchmark_spans: each idle
gap goes to the innermost program span in progress, and only where none
is to the harness's spans; busy time and the window do not depend on
the program's spans; a trace without the recorder's clock anchors, or a
run without its spans, splits the gaps by the harness's spans alone."""

import json

import pytest

from benchmark import spans, trace
from benchmark.tests.test_benchmark_spans import B, _trace

MS = B * 1e6 * 1e-6              # trace seconds a perf millisecond
COPY_END = 4.5 + 10.0 / B * 1e-6  # perf ms


def _harness_only():
    return {"pipeline.align_batch": (1.0 + 0.5 + (6.0 - COPY_END) + 1.5) * MS,
            "engine.run": 0.1 * MS, "io.write": 1.4 * MS,
            "none_of_these": 1.0 * MS}


def test_idle_gaps_by_program_span_first(tmp_path):
    path, rec, harness = _trace(tmp_path)
    r = trace.read(path, 1_000_000, harness, rec["intervals"])
    want = spans.report(path, 1_000_000, harness, rec)
    assert dict(r["idle_gaps"]) == pytest.approx(dict(want["idle_gaps"]))
    assert dict(r["idle_gaps"])["engine.wait"] > 0
    assert dict(r["idle_gaps_harness"]) == pytest.approx(_harness_only())
    assert r["busy_s"] == pytest.approx(want["busy_s"])
    assert r["window_s"] == pytest.approx(want["window_s"])


def test_without_program_spans_or_anchors_the_harness_splits(tmp_path):
    path, rec, harness = _trace(tmp_path)
    r0 = trace.read(path, 1_000_000, harness, rec["intervals"])
    r = trace.read(path, 1_000_000, harness)
    assert dict(r["idle_gaps"]) == pytest.approx(_harness_only())
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    with open(path, "w") as f:
        json.dump({"traceEvents": [e for e in ev if not e["name"].startswith(
            spans.ANCHOR)]}, f)
    r1 = trace.read(path, 1_000_000, harness, rec["intervals"])
    # tied at the window's annotation, the harness's spans drift by 0.1%
    assert dict(r1["idle_gaps"]) == pytest.approx(_harness_only(), rel=2e-3)
    for x in (r, r1):
        assert x["busy_s"] == r0["busy_s"]
        assert x["window_s"] == r0["window_s"]
        assert x["device_ops"] == r0["device_ops"]
