"""Percent of the window's reads that align_batch's sequential stale-rlen
pass ran again (the program's pipeline.replays over pipeline.reads).
Moves mbases_per_s."""

from benchmark import program

UNIT = "%"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    reads = program.counter(ctx, "pipeline.reads")
    replays = program.counter(ctx, "pipeline.replays")
    if not reads or replays is None:
        return None
    return 100.0 * replays / reads
