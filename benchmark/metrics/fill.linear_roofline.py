"""Share of the roofline of the fill kernels (K1, csrc/fill.cu) under the
linear gap model: the least time for the band cells that the window's
fills filled (yardstick_linear.fill_work_linear, from each fill's steps)
against their device time in the profiler's trace. Moves mbases_per_s."""

from benchmark import yardstick, yardstick_linear

UNIT = "%"
LAYER = "kernels"
MOVES = "mbases_per_s"


def read(ctx):
    t = ctx["trace"]
    c = ctx["counters"]
    if t is None or t["by_layer"].get("fill", 0.0) <= 0:
        return None
    ops = nbytes = 0.0
    for tr in (False, True):
        key = "traced" if tr else "untraced"
        o, b = yardstick_linear.fill_work_linear(c[f"fill_cells.{key}"],
                                                 c[f"fill_steps.{key}"],
                                                 c[f"fill_problems.{key}"],
                                                 tr)
        ops += o
        nbytes += b
    return yardstick.share(ops, nbytes, t["by_layer"]["fill"],
                           yardstick.peaks())
