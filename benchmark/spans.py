"""The program's spans (minialign_tpu_torch.stats) laid on a traced run's
device trace: their clock, the card's idle time by the innermost program
span in progress, how much of the harness's own spans they
cover, and how closely each engine.wait ends after its copy.

    python3 -m benchmark.spans --workload <cell> --seed <n> \
        --seconds <s> [--recorder off] [--out report.json]

runs one `--trace 1` run of the cell through run.py as it is, keeps its
chrome trace and the program's record, and prints the report as the
last line of standard output (run.py's own result line before it).
`--recorder off` keeps the recorder from starting (its tick does
nothing), for the recorder's cost against a run with it on. The report
also gives the cyclic garbage collector's time and collections inside
the window.

The recorder marks its clock on the trace with `minialign.clock <ns>`
annotations (<ns> its perf_counter_ns reading as each opens); the
program's intervals go onto the trace's clock by the line through the
first and the last of them, so a drift of one clock against the other
over the window is corrected.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import statistics
import sys
import time

ANCHOR = "minialign.clock "
COARSE = ("pipeline.align_batch", "engine.run", "io.read", "io.write",
          "none_of_these")


def clock_line(events: list):
    """(a, b): trace microseconds = a + b * perf_counter_ns, from the
    first and last clock anchors of a chrome trace's events; None with
    fewer than two."""
    pts = sorted((int(e["name"][len(ANCHOR):]), float(e["ts"]))
                 for e in events if e.get("ph") == "X"
                 and str(e.get("name", "")).startswith(ANCHOR))
    if len(pts) < 2 or pts[-1][0] == pts[0][0]:
        return None
    (n0, t0), (n1, t1) = pts[0], pts[-1]
    b = (t1 - t0) / (n1 - n0)
    return t0 - b * n0, b


def on_trace(intervals: list, line) -> list:
    """stats.read()'s intervals as (name, t0_us, t1_us, thread, depth) on
    the trace's clock."""
    a, b = line
    return [(x[0], a + b * x[1], a + b * x[2], x[4], x[6])
            for x in intervals]


def innermost(spans: list) -> list:
    """The program's timeline: [(t0, t1, name)], at each time the
    innermost span in progress, the deepest and of equal depth the latest
    begun (spans from several threads may overlap); no segment where no
    span is."""
    ev = []
    for j, (_, a, b, _, _) in enumerate(spans):
        if b > a:
            ev.append((a, 1, j))
            ev.append((b, 0, j))
    ev.sort()
    active: set = set()
    out: list = []
    prev = None
    for t, kind, j in ev:
        if active and prev is not None and t > prev:
            k = max(active, key=lambda i: (spans[i][4], spans[i][1]))
            name = spans[k][0]
            if out and out[-1][2] == name and out[-1][1] == prev:
                out[-1][1] = t
            else:
                out.append([prev, t, name])
        if kind:
            active.add(j)
        else:
            active.discard(j)
        prev = t
    return out


def busy_intervals(events: list, w0: float, w1: float) -> list:
    """The union of the device's operations inside [w0, w1] (trace us)."""
    from benchmark import trace
    iv = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS:
            a = float(e["ts"])
            b = a + float(e.get("dur", 0))
            a, b = max(a, w0), min(b, w1)
            if b > a:
                iv.append((a, b))
    return trace._union(iv)


def idle_gaps(busy: list, w0: float, w1: float, timeline: list,
              harness: dict) -> dict:
    """Seconds of the idle time of [w0, w1] by the innermost program span
    in progress (innermost()'s timeline), each gap split where that span
    changes; a part of a gap with no program span goes to the harness's
    spans in progress at its middle (trace.SPAN_ORDER, on the trace's
    clock), then to none_of_these."""
    from benchmark import trace
    starts = {k: [a for a, _ in v] for k, v in harness.items()}
    seg_starts = [a for a, _, _ in timeline]

    def inside(k, t):
        j = bisect.bisect_right(starts.get(k, []), t) - 1
        return j >= 0 and t < harness[k][j][1]

    def fallback(a, b):
        mid = (a + b) / 2
        who = next((k for k in trace.SPAN_ORDER if inside(k, mid)),
                   "none_of_these")
        gaps[who] = gaps.get(who, 0.0) + (b - a) * 1e-6
    gaps: dict = {}
    prev = w0
    for a, b in list(busy) + [[w1, w1]]:
        if a > prev:
            t = prev
            j = max(0, bisect.bisect_right(seg_starts, t) - 1)
            while j < len(timeline) and timeline[j][0] < a:
                s0, s1, name = timeline[j]
                lo, hi = max(s0, t), min(s1, a)
                if hi > lo:
                    if lo > t:
                        fallback(t, lo)
                    gaps[name] = gaps.get(name, 0.0) + (hi - lo) * 1e-6
                    t = hi
                j += 1
            if a > t:
                fallback(t, a)
        prev = max(prev, b)
    return gaps


def covered(outer: list, inner: list) -> float:
    """The share of the union of `outer` intervals that the union of
    `inner` ones covers (one clock, any unit)."""
    from benchmark import trace
    o = trace._union(outer)
    i = trace._union(inner)
    tot = sum(b - a for a, b in o)
    if tot <= 0:
        return float("nan")
    got, j = 0.0, 0
    for a, b in o:
        while j < len(i) and i[j][1] <= a:
            j += 1
        k = j
        while k < len(i) and i[k][0] < b:
            got += min(b, i[k][1]) - max(a, i[k][0])
            k += 1
    return got / tot


def wait_lag(events: list, waits: list, w0: float, w1: float,
             edge_us: float = 5e6) -> dict:
    """For each engine.wait span (trace us) holding the end of a device
    to host copy, the time from that copy's end to the span's end (us);
    the median in the window's first and last `edge_us`."""
    ends = sorted(float(e["ts"]) + float(e.get("dur", 0)) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                  and "DtoH" in str(e.get("name", "")))
    first, last, n = [], [], 0
    for a, b in waits:
        j = bisect.bisect_right(ends, b) - 1
        if j < 0 or ends[j] < a:
            continue
        n += 1
        lag = b - ends[j]
        if a < w0 + edge_us:
            first.append(lag)
        if b > w1 - edge_us:
            last.append(lag)
    med = (lambda v: statistics.median(v) if v else None)
    return {"matched": n, "waits": len(waits),
            "first_5s_median_us": med(first), "first_5s_n": len(first),
            "last_5s_median_us": med(last), "last_5s_n": len(last)}


def report(path: str, host_t0_ns: int, harness_ns: dict, rec: dict) -> dict:
    """The program's spans on the chrome trace at `path`; harness_ns are
    the harness's spans, {name: [(t0_ns, t1_ns)]}, on perf_counter_ns,
    rec the program's stats.read()."""
    from benchmark import trace
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    win = next(e for e in ev if e.get("name") == "bench.window"
               and e.get("ph") == "X")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    line = clock_line(ev)
    out = {"anchors": len(rec["anchors"])}
    if line is None:
        out["error"] = "fewer than two clock anchors on the trace"
        return out
    # where the anchors' line puts the window's first clock reading,
    # against trace.read's own tie of it to the window's annotation
    a, b = line
    out["clock"] = {"us_per_ns": b, "offset_vs_window_tie_us":
                    (a + b * host_t0_ns) - w0}
    harness = {k: trace._union([(a + b * t0, a + b * t1) for t0, t1 in v])
               for k, v in harness_ns.items()}
    prog = [x for x in on_trace(rec["intervals"], line)
            if x[1] < w1 and x[2] > w0]
    busy = busy_intervals(ev, w0, w1)
    gaps = idle_gaps(busy, w0, w1, innermost(prog), harness)
    idle = sum(gaps.values())
    out["window_s"] = (w1 - w0) * 1e-6
    out["busy_s"] = sum(y - x for x, y in busy) * 1e-6
    out["idle_gaps"] = sorted(([k, v] for k, v in gaps.items()),
                              key=lambda x: -x[1])
    out["idle_coarse_share"] = (sum(gaps.get(k, 0.0) for k in COARSE)
                                / idle if idle > 0 else None)
    # coverage, on the host's clock
    iv = rec["intervals"]
    top = [(x[1], x[2]) for x in iv if x[6] == 0]
    out["coverage"] = {
        "align_batch_by_program": covered(
            harness_ns["pipeline.align_batch"],
            [(x[1], x[2]) for x in iv if x[0].startswith(
                ("pipeline.", "engine."))]),
        "io_by_parse_format": covered(
            harness_ns["io.read"] + harness_ns["io.write"],
            [(x[1], x[2]) for x in iv if x[0] in ("io.parse",
                                                  "io.format")]),
        "engine_run_by_engine": covered(
            harness_ns["engine.run"],
            [(x[1], x[2]) for x in iv if x[0] in (
                "engine.submit", "engine.wait", "engine.harvest")]),
        "window_by_program_top": covered(
            [(host_t0_ns, host_t0_ns + (w1 - w0) * 1e3)], top)}
    out["wait_lag"] = wait_lag(
        ev, [(x[1], x[2]) for x in prog if x[0] == "engine.wait"], w0, w1)
    out["spans"] = rec["spans"]
    out["counters"] = rec["counters"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", choices=("on", "off"), default="on")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    from benchmark import run, trace
    from minialign_tpu_torch import stats
    if a.recorder == "off":
        stats.tick = lambda: None
    got: dict = {}
    read, run_cell = trace.read, run.run_cell

    def keep_read(path, host_t0_ns, spans, *program):
        got["trace"] = read(path, host_t0_ns, spans, *program)
        if a.recorder == "on":
            got["report"] = report(path, host_t0_ns, spans, stats.read())
        return got["trace"]

    def keep_cell(*args, **kw):
        r = run_cell(*args, **kw)
        got["window"] = r["ctx"]["window"]
        return r
    trace.read, run.run_cell = keep_read, keep_cell
    collections: list = []       # (start, seconds, generation)

    def timed(phase, info):
        if phase == "start":
            got["gc0"] = time.perf_counter()
        else:
            collections.append((got["gc0"], time.perf_counter() - got["gc0"],
                                info["generation"]))
    gc.callbacks.append(timed)
    rc = run.main(["--workload", a.workload, "--seed", str(a.seed),
                   "--seconds", str(a.seconds), "--trace", "1"])
    if rc != 0 or "window" not in got:
        return rc or 1
    gc.callbacks.remove(timed)
    w = got["window"]
    inside = [c for c in collections if w.t0 <= c[0] <= w.t1]
    out = got.get("report", {}) | {
        "gc_window": {"s": sum(c[1] for c in inside), "n": len(inside),
                      "gen2": sum(c[2] == 2 for c in inside)},
        "recorder": a.recorder, "workload": a.workload, "seed": a.seed,
        "window_mbases_per_s": w.bases / 1e6 / w.seconds,
        "batches": w.batches, "harness_idle_gaps":
            got["trace"]["idle_gaps_harness"] if got.get("trace") else None}
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f)
    sys.stdout.flush()
    print(json.dumps({k: v for k, v in out.items() if k != "spans"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
