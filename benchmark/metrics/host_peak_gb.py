"""The measured process's peak resident memory over set-up and window
(ru_maxrss), read as the window closes, before the reference runs."""

UNIT = "GB"


def read(ctx):
    return ctx["host_peak_bytes"] / 1e9
