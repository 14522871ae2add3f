"""Milliseconds a read Mbase in the window's io spans: the harness's
spans around each next batch of io.bseq.read_batches and around the
io.sam writer's calls for the batch. Moves mbases_per_s."""

UNIT = "ms/Mbase"
LAYER = "io"
MOVES = "mbases_per_s"


def read(ctx):
    w = ctx["window"]
    s = ctx["spans"]
    if not ctx["traced"] or w.bases == 0:
        return None
    return (s["io.read"] + s["io.write"]) * 1e3 / (w.bases / 1e6)
