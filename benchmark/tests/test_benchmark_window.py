"""The window's arithmetic: whole batches, the end at the first batch
that completes after the window's length, the pool read again."""

import pytest

from benchmark import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_ends_on_first_completion_after_length():
    clk = Clock()
    cost = [3.0, 3.0, 3.0, 3.0, 3.0]
    it = iter(range(5))

    def process(b):
        clk.t += cost[b]
        return 10, 1000 * (b + 1)
    w = window.run(it, process, 7.0, clock=clk)
    # batches end at 3, 6, 9: the third is the first past 7 s
    assert (w.batches, w.reads, w.bases) == (3, 30, 1000 + 2000 + 3000)
    assert w.seconds == pytest.approx(9.0)


def test_exact_boundary_and_zero_length():
    clk = Clock()

    def process(b):
        clk.t += 2.0
        return 1, 5
    w = window.run(iter(range(10)), process, 4.0, clock=clk)
    assert w.batches == 2 and w.seconds == pytest.approx(4.0)
    w = window.run(iter(range(10)), process, 0.0, clock=clk)
    assert w.batches == 1


def test_pool_restarts():
    opened = []

    def open_batches():
        opened.append(1)
        return iter(["a", "b", "c"])
    src = window.cycle(open_batches)
    got = [next(src) for _ in range(7)]
    assert got == ["a", "b", "c", "a", "b", "c", "a"]
    assert len(opened) == 3
    with pytest.raises(ValueError):
        next(window.cycle(lambda: iter([])))
