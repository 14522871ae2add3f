"""Percent of the extension requests that a window's read passes made
(the first pass and the stale-rlen replays) that were answered from the
read's lane memo on the host instead of the engine: the program's
pipeline.lane_hits over pipeline.ext_reqs. 0 where no read's chains fall
on two or more target sequences; a program without the counters reads
nothing. Moves mbases_per_s."""

from benchmark import program

UNIT = "%"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    reqs = program.counter(ctx, "pipeline.ext_reqs")
    hits = program.counter(ctx, "pipeline.lane_hits")
    if not reqs or hits is None:
        return None
    return 100.0 * hits / reqs
