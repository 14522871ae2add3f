"""The device's side of a traced window, read from torch.profiler's
chrome trace: busy time (the union of kernels, copies and sets), device
time by operation and by layer (kernels.json), and the idle gaps
attributed to what the host was doing then (the harness's spans).

The trace's clock and the host's are tied by the `bench.window`
annotation, which opens as the window's first clock reading is taken.
"""

from __future__ import annotations

import bisect
import json
import os

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


def read(path: str, host_t0_ns: int, spans: dict) -> dict:
    """Summary of a chrome trace; spans: {name: [(t0_ns, t1_ns)]} on the
    host clock whose reading at the window's start is host_t0_ns."""
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
    # host spans on the trace's clock (microseconds)
    off = w0 - host_t0_ns / 1e3
    sp = {k: _union((a / 1e3 + off, b / 1e3 + off) for a, b in v)
          for k, v in spans.items()}
    starts = {k: [a for a, _ in v] for k, v in sp.items()}

    def inside(k, t):
        j = bisect.bisect_right(starts.get(k, []), t) - 1
        return j >= 0 and t < sp[k][j][1]
    gaps: dict = {}
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            mid = (prev + a) / 2
            who = next((k for k in SPAN_ORDER if inside(k, mid)),
                       "none_of_these")
            gaps[who] = gaps.get(who, 0.0) + (a - prev) * 1e-6
        prev = max(prev, b)
    top = sorted(by_op.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "by_layer": by_layer,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(gaps.items(), key=lambda x: -x[1])[:10]]}
