"""Milliseconds a read Mbase of the program's engine.harvest self time:
decoding the read-backs into results (run-length paths, TraceResults),
the waits left out. Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "engine"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "engine.harvest", "self_s")
