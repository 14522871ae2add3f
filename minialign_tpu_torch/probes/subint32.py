"""P1: sub-int32 add, maximum, compare-gt and select, alone and in an
8-round loop carry (csrc/probe_subint32.cu).

Replaces tests/tools/probe_subint32.py:probe and :probe_carry. There the
question was which int16 / int8 / uint8 vector ops Mosaic legalizes on
the TPU; here every case runs, and the question is whether the kernel
computes what JAX types: every op wraps to the input's width, uint8
compares are unsigned, the result is widened to int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import (BINOPS, LIBRARY_BINOP, Report, binop, binop_plain,
                      carry_plain, inputs)

RANGE = (-100, 100)    # the tool's inputs, cut to the dtype
DTYPES = ("int16", "int8", "uint8")
CARRY_OPS = ("maximum", "select")     # the tool's probe_carry cases
ROUNDS = 8


def probe_plain(op: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return binop_plain(op, x, y).to(torch.int32)


def probe_carry_plain(op: str, x: torch.Tensor, y: torch.Tensor,
                      rounds: int = ROUNDS) -> torch.Tensor:
    return carry_plain(op, x, y, rounds).to(torch.int32)


def probe(op: str, x, y, device="cuda") -> torch.Tensor:
    """op(x, y) in x's type, as int32 (probe_subint32.probe)."""
    return binop("p1", "p1_probe_launch", torch.int32, op, x, y, device, 0)


def probe_carry(op: str, x, y, device="cuda",
                rounds: int = ROUNDS) -> torch.Tensor:
    """c <- op(c, y) cut to x's type, `rounds` times from c = x, as int32
    (probe_subint32.probe_carry)."""
    if rounds < 1:
        raise ValueError("probe_carry: rounds must be at least 1")
    return binop("p1", "p1_probe_launch", torch.int32, op, x, y, device,
                 rounds)


def main(rep: Report, rng: np.random.Generator) -> None:
    """probe_subint32.py's __main__: 3 dtypes x 6 cases."""
    for dt in DTYPES:
        rep.say(f"[{dt}]")
        for op in BINOPS:
            x, y = inputs(rng, dt, rep.device, *RANGE)
            rep.case(f"{dt} {op}", "p1",
                     lambda: probe(op, x, y, rep.device),
                     lambda: probe_plain(op, x, y), ((x, y), 1),
                     lambda: LIBRARY_BINOP[op](x, y))
        for op, nm in zip(CARRY_OPS, ("max-in-carry", "sel-in-carry")):
            x, y = inputs(rng, dt, rep.device, *RANGE)
            rep.case(f"carry {dt} {nm}", "p1",
                     lambda: probe_carry(op, x, y, rep.device),
                     lambda: probe_carry_plain(op, x, y), ((x, y), ROUNDS))
