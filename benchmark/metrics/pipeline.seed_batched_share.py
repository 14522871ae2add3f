"""Percent of the window's reads whose round-0 seeds came from the batch's
device seed pass (the program's pipeline.seed_batched over pipeline.reads);
the rest seed a read at a time on the host. A program without the pass
has no such counter, and the metric reads nothing. Moves mbases_per_s."""

from benchmark import program

UNIT = "%"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    reads = program.counter(ctx, "pipeline.reads")
    batched = program.counter(ctx, "pipeline.seed_batched")
    if not reads or batched is None:
        return None
    return 100.0 * batched / reads
