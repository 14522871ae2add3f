"""Milliseconds a read Mbase in the program's io.parse spans:
io.bseq.read_batches from a batch's first read to its yield (the FASTQ
read and parse). Moves mbases_per_s."""

from benchmark import program

UNIT = "ms/Mbase"
LAYER = "io"
MOVES = "mbases_per_s"


def read(ctx):
    return program.span_ms_per_mbase(ctx, "io.parse")
