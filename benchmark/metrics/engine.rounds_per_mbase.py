"""Host-device round trips a read Mbase: the program's engine.rounds, one
a FillEngine.run call (its launches, then its read-backs). Moves
mbases_per_s."""

from benchmark import program

UNIT = "rounds/Mbase"
LAYER = "engine"
MOVES = "mbases_per_s"


def read(ctx):
    n = program.counter(ctx, "engine.rounds")
    if not n or ctx["window"].bases == 0:
        return None
    return n / (ctx["window"].bases / 1e6)
