"""Milliseconds a read Mbase in the program's pipeline.seed spans: each read's
collect_seeds and seed rounds in extend.extend_read (index lookups).
Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "pipeline.seed")
