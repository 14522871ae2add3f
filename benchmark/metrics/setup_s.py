"""Seconds from the harness's start to the window's first read: inputs
written, index built, engine made, kernels built or loaded, one warm-up
batch."""

UNIT = "s"


def read(ctx):
    return ctx["setup_s"]
