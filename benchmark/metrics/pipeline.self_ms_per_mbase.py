"""Milliseconds a read Mbase that pipeline.align_batch spends outside
the engine: its span less the time in which an engine.run (timed by the
harness's proxy, on any scheduler thread) was in progress. Seeding,
chaining, extension bookkeeping and post-processing. Moves mbases_per_s."""

UNIT = "ms/Mbase"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    w = ctx["window"]
    if not ctx["traced"] or w.bases == 0 or ctx["align_batch_s"] <= 0:
        return None
    self_s = ctx["align_batch_s"] - ctx["engine_run_union_s"]
    return self_s * 1e3 / (w.bases / 1e6)
