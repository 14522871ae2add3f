"""Alignments that the pipeline reports a read over the window: the
program's pipeline.alns (the alignments _postprocess returns for each
read, summed) over pipeline.reads. A program without the counter reads
nothing. Moves mbases_per_s."""

from benchmark import program

UNIT = "alns/read"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    reads = program.counter(ctx, "pipeline.reads")
    alns = program.counter(ctx, "pipeline.alns")
    if not reads or alns is None:
        return None
    return alns / reads
