"""Read bases mapped a second over the whole window: every base of the
completed batches, from the first read to the last completion (SAM
printed, index built in set-up)."""

UNIT = "Mbases/s"


def read(ctx):
    w = ctx["window"]
    return w.bases / 1e6 / w.seconds if w.seconds > 0 else None
