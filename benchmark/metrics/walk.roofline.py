"""Share of the roofline of the walk kernel (K3, csrc/dtrace.cu): the
least time for the moves of the traced paths (yardstick.walk_work)
against its device time in the profiler's trace. Moves mbases_per_s."""

from benchmark import yardstick

UNIT = "%"
LAYER = "kernels"
MOVES = "mbases_per_s"


def read(ctx):
    t = ctx["trace"]
    c = ctx["counters"]
    if t is None or t["by_layer"].get("walk", 0.0) <= 0 \
            or c["walk_moves"] <= 0:
        return None
    o, b = yardstick.walk_work(c["walk_moves"], c["walk_problems"])
    return yardstick.share(o, b, t["by_layer"]["walk"], yardstick.peaks())
