"""Milliseconds a read Mbase in the program's io.format spans of the PAF
writer: io.sam.PafWriter formatting each read's lines, its writes to the
sink included. A program whose PafWriter has no span reads nothing.
Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "io"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "io.format")
