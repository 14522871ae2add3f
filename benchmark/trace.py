"""The device's side of a traced window, read from torch.profiler's
chrome trace: busy time (the union of kernels, copies and sets), device
time by operation and by layer (kernels.json), and the idle gaps
attributed to what the host was doing then: the innermost of the
program's spans in progress (spans.idle_gaps), and where none was, the
harness's spans.

The program's spans go onto the trace's clock by the recorder's clock
anchors (spans.clock_line). The harness's go by those too, or, on a
trace without two anchors, by the `bench.window` annotation, which
opens as the window's first clock reading is taken.
"""

from __future__ import annotations

import json
import os

from . import spans as program_spans

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# innermost first: an idle gap goes to the first of these in progress
SPAN_ORDER = ("engine.run", "pipeline.align_batch", "io.write", "io.read")


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and argument list, at most 64 characters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return (name.split("(")[0].strip() or name)[:64]


def kernel_layers() -> list:
    with open(os.path.join(os.path.dirname(__file__), "kernels.json")) as f:
        return json.load(f)["layers"]


def layer_of(name: str, table: list) -> str:
    return next((layer for pat, layer in table if pat in name), "other")


def _union(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(path: str, host_t0_ns: int, spans: dict,
         program: list | None = None) -> dict:
    """Summary of a chrome trace; spans: {name: [(t0_ns, t1_ns)]} on the
    host clock whose reading at the window's start is host_t0_ns;
    program: the recorder's intervals (stats.read()), or None."""
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    win = next(e for e in ev if e.get("name") == "bench.window"
               and e.get("ph") == "X")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev = [e for e in ev if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    by_op: dict = {}
    by_layer: dict = {}
    table = kernel_layers()
    iv = []
    for e in dev:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        iv.append((a, b))
        nm = short_name(e.get("name", "?"))
        by_op[nm] = by_op.get(nm, 0.0) + (b - a) * 1e-6
        ly = layer_of(nm, table)
        by_layer[ly] = by_layer.get(ly, 0.0) + (b - a) * 1e-6
    busy = _union(iv)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    line = program_spans.clock_line(ev)
    if line is None:
        a, b = w0 - host_t0_ns / 1e3, 1e-3
    else:
        a, b = line
    sp = {k: _union((a + b * t0, a + b * t1) for t0, t1 in v)
          for k, v in spans.items()}
    timeline = []
    if line is not None and program:
        timeline = program_spans.innermost(
            [x for x in program_spans.on_trace(program, line)
             if x[1] < w1 and x[2] > w0])
    gaps = program_spans.idle_gaps(busy, w0, w1, timeline, sp)
    harness_gaps = program_spans.idle_gaps(busy, w0, w1, [], sp)
    top = sorted(by_op.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "by_layer": by_layer,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": _top(gaps), "idle_gaps_harness": _top(harness_gaps)}


def _top(gaps: dict) -> list:
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda x: -x[1])[:10]]
