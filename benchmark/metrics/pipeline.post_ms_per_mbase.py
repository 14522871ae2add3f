"""Milliseconds a read Mbase of the program's pipeline.post self time:
align_batch's sequential stale-rlen pass (its replays' extension left out)
and its post-processing into Regs. Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "pipeline.post", "self_s")
