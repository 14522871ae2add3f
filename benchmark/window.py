"""The measured window: whole batches from a pool that is read again from
its start when it runs out, until the first batch that completes after
the window's length.

The window starts when the first timed batch is read and ends when the
last batch completes; the rate is every base of the completed batches
over that whole span, so no part batch is lost or counted.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator


@dataclasses.dataclass
class Window:
    t0: float          # clock at the first read
    t1: float          # clock when the last batch completed
    batches: int
    bases: int
    reads: int
    batch_s: list       # each batch's seconds, read to completion

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def cycle(open_batches: Callable[[], Iterable]) -> Iterator:
    """Batches of open_batches(), started again each time it ends."""
    while True:
        empty = True
        for b in open_batches():
            empty = False
            yield b
        if empty:
            raise ValueError("the read pool holds no batch")


def run(batches: Iterator, process: Callable, seconds: float,
        clock: Callable[[], float] = time.perf_counter) -> Window:
    """Runs process(batch) -> (reads, bases) on whole batches until the
    first one that completes `seconds` or more after the first read."""
    t0 = t = clock()
    n = bases = reads = 0
    each = []
    while True:
        r, b = process(next(batches))
        n += 1
        reads += r
        bases += b
        t1 = clock()
        each.append(t1 - t)
        t = t1
        if t1 - t0 >= seconds:
            return Window(t0, t1, n, bases, reads, each)
