"""Milliseconds a read Mbase in the program's pipeline.chain spans: each
chain_seeds call in extend.extend_read. Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "pipeline.chain")
