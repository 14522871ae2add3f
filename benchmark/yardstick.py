"""The least time the chip could take for the work that the fill (K1)
and the walk (K3) did, from the Gotoh recurrence and not from any
kernel's instructions, against the published peaks (peaks.json).

Fill, per band cell (W lanes a step, `n_steps` steps a problem), with
the combined gap model of the -x presets:
  diagonal      H(i-1, j-1) + s(a_i, b_j)                1 add
  affine gaps   E = max(E - ge, H - gi - ge), F alike    2 x (2 sub + 1 max)
  linear gaps   H - gfa, H - gfb                         2 sub
  the cell      max of five                              4 max
  band maximum  compare with the running maximum        1 max
  = 14 operations. A traced fill also works out its 6-bit move code, six
  compares, and stores it: 20 operations and 6 bits written a cell.
Bytes: each problem reads its two windows once, one base a step, and
writes its result (score, i, j, steps: 16 bytes).

Walk, per move of the traced path (one base of either side): read the
cell's 6-bit code, compare it with the state (3 operations), step the
position (2), and write 2 bits of path.
"""

from __future__ import annotations

import json
import os

FILL_OPS = 14
FILL_OPS_TRACED = 20
TRACE_BITS = 6
RESULT_BYTES = 16
WALK_OPS = 5
WALK_BITS_OUT = 2


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
        return json.load(f)


def fill_work(cells: int, steps: int, problems: int,
              traced: bool) -> tuple[float, float]:
    """(operations, bytes) of fills that filled `cells` band cells in
    `steps` steps over `problems` problems."""
    ops = cells * (FILL_OPS_TRACED if traced else FILL_OPS)
    nbytes = steps + problems * RESULT_BYTES
    if traced:
        nbytes += cells * TRACE_BITS / 8
    return float(ops), float(nbytes)


def walk_work(moves: int, problems: int) -> tuple[float, float]:
    return (float(moves * WALK_OPS),
            moves * (TRACE_BITS + WALK_BITS_OUT) / 8 + problems * RESULT_BYTES)


def least_seconds(ops: float, nbytes: float, pk: dict) -> float:
    return max(ops / pk["int32_ops_per_s"], nbytes / pk["hbm_bytes_per_s"])


def share(ops: float, nbytes: float, seconds: float, pk: dict) -> float | None:
    """Percent of the roofline, or None when there is nothing to rate."""
    if seconds <= 0 or ops <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes, pk) / seconds
