"""Seconds of the set-up's index build on the host clock: the CLI's
cli._iter_index_blocks (the FASTA read, then index.build.build_index
with the host library csrc/host/). Moves setup_s."""

UNIT = "s"
LAYER = "index"
MOVES = "setup_s"


def read(ctx):
    return ctx["index_build_s"] if ctx["traced"] else None
