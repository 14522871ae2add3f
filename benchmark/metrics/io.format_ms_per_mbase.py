"""Milliseconds a read Mbase in the program's io.format spans: io.sam.SamWriter
formatting each read's records, its writes to the sink included. Moves
mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "io"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "io.format")
