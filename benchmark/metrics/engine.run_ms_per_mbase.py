"""Milliseconds a read Mbase in which an engine.run was in progress (the
union over the scheduler threads of the proxy's spans): the fill
engine's uploads, launches and harvests. Moves mbases_per_s."""

UNIT = "ms/Mbase"
LAYER = "engine"
MOVES = "mbases_per_s"


def read(ctx):
    w = ctx["window"]
    if not ctx["traced"] or w.bases == 0 or ctx["engine_run_union_s"] <= 0:
        return None
    return ctx["engine_run_union_s"] * 1e3 / (w.bases / 1e6)
