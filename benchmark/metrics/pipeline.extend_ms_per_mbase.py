"""Milliseconds a read Mbase of the program's pipeline.extend self time:
align_batch's loops that send to the extension generators, less the
seeding, chaining and engine spans inside them (the generators'
bookkeeping). Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "pipeline"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "pipeline.extend", "self_s")
