"""Spans and counters of the port's own layers, kept in memory until read.

A span is a named interval on `time.perf_counter_ns`, recorded where the
work happens: its start and end, its thread, its parent (the innermost
span open on the same thread when it began), and the batch (the batch's
first qid) and read (qid) it belongs to where the site has them. Spans
never stay open across a generator's `yield`. Counters are named
integers added to at the same sites; launch shapes count the engine's
traced and duo launch batches by (kind, nreal, B).

The recorder is off by default. Each instrumented site then costs one
test of the module flag `ON`: no allocation, no clock read. It is on

  * for the whole process when MINIALIGN_STATS is set; at exit it prints
    one `[stats] <kind> nreal=<n> B=<B> x<count>` line a launch shape
    (nreal the batch's problem count rounded up to 16, as the JAX engine
    counts it; B the launch's own count), then one `[stats] span` line a
    span name (count, total and self seconds) and one `[stats] counter`
    line a counter, on stderr;
  * between start() and stop();
  * while a torch.profiler records: tick(), called at each read batch,
    starts it when a profiler is on and stops it at the first tick after
    the profiler ended.

While the recorder is on under a profiler, each tick (and start and
stop) emits a `record_function` anchor named `minialign.clock <ns>`,
<ns> the perf_counter_ns reading taken as it opens, so that the spans
can be put on the chrome trace's clock by the line through two anchors.

read() returns everything recorded: totals by name (count, total, self
time, where self time is a span's duration less that of its child
spans), the intervals, the counters, the launch shapes and the anchors.
"""

from __future__ import annotations

import os
import sys
import threading
import time

ON = False

_clock = time.perf_counter_ns
_lock = threading.Lock()
_local = threading.local()
_gen = 0               # bumped by reset(): threads' buffers start anew
_threads: list = []    # (thread ident, _Thread) in first-use order
_counters: dict = {}
_shapes: dict = {}     # (kind, nreal, B) -> launch batches
_anchors: list = []
_by_profiler = False
_dump_registered = False


class _Thread:
    """One thread's spans: the open ones, innermost last, as (id, name,
    t0, parent id, batch, qid), and the closed ones with t1 added, in the
    order they closed. Ids count the thread's spans in the order they
    began. Closed spans are tuples of ints and a str, which the cyclic
    garbage collector stops tracking, so a long window's spans add
    nothing to its collections."""

    __slots__ = ("gen", "n", "spans", "stack")

    def __init__(self, gen: int):
        self.gen = gen
        self.n = 0
        self.spans: list = []
        self.stack: list = []


def _mine() -> _Thread:
    t = getattr(_local, "t", None)
    if t is None or t.gen != _gen:
        t = _local.t = _Thread(_gen)
        with _lock:
            _threads.append((threading.get_ident(), t))
    return t


def begin(name: str, batch: int = -1, qid: int = -1) -> int:
    """Opens a span on this thread; returns its token for end()."""
    t = _mine()
    i = t.n
    t.n = i + 1
    st = t.stack
    st.append((i, name, _clock(), st[-1][0] if st else -1, batch, qid))
    return i


def end(i: int) -> None:
    """Closes the span that begin() opened on this thread; a span still
    open inside it is dropped. A token from before a reset() is
    ignored."""
    now = _clock()
    t = _mine()
    st = t.stack
    k = len(st) - 1
    while k >= 0 and st[k][0] != i:
        k -= 1
    if k < 0:
        return
    t.spans.append(st[k] + (now,))
    del st[k:]


def add(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def launch(kind: str, B: int) -> None:
    """Counts one launch batch of `kind` ('trace': ups walked on the
    device; 'duo') holding B problems."""
    key = (kind, -(-B // 16) * 16, B)
    with _lock:
        _shapes[key] = _shapes.get(key, 0) + 1


def _profiling() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(prof is not None and getattr(prof, "_is_profiler_enabled",
                                             False))


def _anchor() -> None:
    from torch.autograd.profiler import record_function
    ns = _clock()
    with record_function(f"minialign.clock {ns}"):
        pass
    with _lock:
        _anchors.append(ns)


def start() -> None:
    global ON
    ON = True
    if _profiling():
        _anchor()


def stop() -> None:
    global ON, _by_profiler
    if ON and _profiling():
        _anchor()
    ON = _by_profiler = False


def tick() -> None:
    """At a batch boundary: follow a torch.profiler (see the module's
    docstring) and, while on under one, emit a clock anchor."""
    global _by_profiler
    prof = _profiling()
    if prof and not ON:
        start()
        _by_profiler = True
    elif prof:
        _anchor()
    elif _by_profiler:
        stop()


def reset() -> None:
    """Drops everything recorded; open spans' tokens become void."""
    global _gen
    with _lock:
        _gen += 1
        _threads.clear()
        _counters.clear()
        _shapes.clear()
        _anchors.clear()


def read(since_ns: int | None = None, until_ns: int | None = None) -> dict:
    """What was recorded, of the closed spans those that began within
    [since_ns, until_ns] (all by default):

      spans:     {name: {"count", "total_s", "self_s"}}
      intervals: [(name, t0_ns, t1_ns, self_ns, thread, parent, depth,
                   batch, qid)], parent an index into this list or -1,
                   depth 0 for a span with no parent
      counters:  {name: int}
      launch_shapes: [(kind, nreal, B, launch batches)]
      anchors:   [perf_counter_ns of each clock anchor]
    """
    lo = -1 if since_ns is None else since_ns
    hi = float("inf") if until_ns is None else until_ns
    with _lock:
        threads = list(_threads)
        out = {"counters": dict(_counters),
               "launch_shapes": [(*k, n) for k, n in sorted(_shapes.items())],
               "anchors": list(_anchors)}
    intervals: list = []
    for tid, t in threads:
        recs = sorted(t.spans)               # by id: parents first
        child: dict = {}
        depth: dict = {}
        for i, _, a, par, _, _, b in recs:
            depth[i] = depth[par] + 1 if par in depth else 0
            child[par] = child.get(par, 0) + b - a
        keep: dict = {}
        for i, name, a, par, batch, qid, b in recs:
            if lo <= a <= hi:
                keep[i] = len(intervals)
                intervals.append((name, a, b, b - a - child.get(i, 0), tid,
                                  keep.get(par, -1), depth[i], batch, qid))
    spans: dict = {}
    for name, a, b, self_ns, *_ in intervals:
        s = spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += (b - a) * 1e-9
        s["self_s"] += self_ns * 1e-9
    out["spans"] = spans
    out["intervals"] = intervals
    return out


def _dump() -> None:
    r = read()
    for kind, nreal, B, n in r["launch_shapes"]:
        print(f"[stats] {kind} nreal={nreal} B={B} x{n}", file=sys.stderr)
    for name, s in sorted(r["spans"].items()):
        print(f"[stats] span {name} n={s['count']} total_s="
              f"{s['total_s']:.6f} self_s={s['self_s']:.6f}",
              file=sys.stderr)
    for name, v in sorted(r["counters"].items()):
        print(f"[stats] counter {name} {v}", file=sys.stderr)


def from_env() -> bool:
    """Turns the recorder on for the process, with the report at exit,
    when MINIALIGN_STATS is set; returns whether it is set."""
    global _dump_registered
    if not os.environ.get("MINIALIGN_STATS"):
        return False
    start()
    if not _dump_registered:
        import atexit
        atexit.register(_dump)
        _dump_registered = True
    return True


from_env()
