"""Milliseconds a read Mbase in the program's engine.wait spans: the
engine's blocking read-backs (the summaries and the walk's run-length
entries), in which the host waits for the card. Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "engine"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "engine.wait")
