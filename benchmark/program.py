"""The program's own spans and counters over a traced window, for the
metric readers: what minialign_tpu_torch.stats recorded between the
window's first read and its last completion.

The recorder follows torch.profiler, so in a `--trace 1` run on the card
it is on from the window's first batch, the warm-up left out. A program
without the recorder, or a run in which it recorded nothing (untraced,
or traced on the CPU, where the harness runs no profiler), gives None,
and each metric that reads it nothing.
"""

from __future__ import annotations

_memo: dict = {}


def window(ctx) -> dict | None:
    """stats.read() over the window: spans that began inside it, and the
    counters (the recorder starts with the window, so they are its)."""
    if not ctx.get("traced") or "window" not in ctx:
        return None
    try:
        from minialign_tpu_torch import stats
    except ImportError:
        return None
    w = ctx["window"]
    key = (id(ctx), w.t0, w.t1)
    if key not in _memo:
        _memo.clear()
        rec = stats.read(int(w.t0 * 1e9), int(w.t1 * 1e9))
        _memo[key] = rec if rec["intervals"] else None
    return _memo[key]


def intervals() -> list | None:
    """Every span that the recorder closed, as stats.read()'s intervals
    (trace.read keeps those inside its window), or None without the
    recorder."""
    try:
        from minialign_tpu_torch import stats
    except ImportError:
        return None
    return stats.read()["intervals"]


def span_ms_per_mbase(ctx, name: str, field: str = "total_s"):
    """A span's total (or self) time over the window's scheduler threads,
    in ms a read Mbase of the window."""
    rec = window(ctx)
    if rec is None or name not in rec["spans"] or ctx["window"].bases == 0:
        return None
    return rec["spans"][name][field] * 1e3 / (ctx["window"].bases / 1e6)


def counter(ctx, name: str):
    rec = window(ctx)
    return None if rec is None else rec["counters"].get(name)
