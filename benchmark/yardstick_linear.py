"""The least work of the fill (K1) under the linear gap model (gi = 0,
the `ava` preset's -p0), counted from the recurrence and not from any
kernel's instructions, as yardstick.py counts the combined model's.

Per band cell, H(i, j) = max(H(i-1, j-1) + s(a_i, b_j), H(i-1, j) - ge,
H(i, j-1) - ge):
  diagonal      H(i-1, j-1) + s(a_i, b_j)                1 add
  gaps          H(i-1, j) - ge, H(i, j-1) - ge           2 sub
  the cell      max of three                             2 max
  band maximum  compare with the running maximum        1 max
  = 6 operations. A traced fill also works out the cell's move, which of
  the three won (2 compares), and stores it: 8 operations and 2 bits
  written a cell.
Bytes as yardstick.fill_work: each problem reads its two windows once,
one base a step, and writes its result (score, i, j, steps: 16 bytes).
"""

from __future__ import annotations

from benchmark.yardstick import RESULT_BYTES

FILL_OPS_LINEAR = 6
FILL_OPS_LINEAR_TRACED = 8
TRACE_BITS_LINEAR = 2


def fill_work_linear(cells: int, steps: int, problems: int,
                     traced: bool) -> tuple[float, float]:
    """(operations, bytes) of linear-model fills that filled `cells` band
    cells in `steps` steps over `problems` problems."""
    ops = cells * (FILL_OPS_LINEAR_TRACED if traced else FILL_OPS_LINEAR)
    nbytes = steps + problems * RESULT_BYTES
    if traced:
        nbytes += cells * TRACE_BITS_LINEAR / 8
    return float(ops), float(nbytes)
