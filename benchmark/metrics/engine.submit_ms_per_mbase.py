"""Milliseconds a read Mbase in the program's engine.submit spans: each
FillEngine.run up to its last launch (grouping, descriptor packing, the
upload, the fill and walk launches) and each batch's upload of its
sequence stores. Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "engine"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "engine.submit")
