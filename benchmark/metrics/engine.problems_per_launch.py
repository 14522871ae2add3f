"""Fill problems a fill launch over the window: the problems of each
store-mode fill launch (the port's _build.FUSED_SHAPES) over its fill
launches (_build.LAUNCHES["fill"]). Moves mbases_per_s."""

UNIT = "problems/launch"
LAYER = "engine"
MOVES = "mbases_per_s"


def read(ctx):
    c = ctx["counters"]
    if not ctx["traced"] or c["fill_launches"] <= 0:
        return None
    return c["fill_problems"] / c["fill_launches"]
