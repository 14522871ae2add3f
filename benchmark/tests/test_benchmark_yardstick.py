"""The roofline's work count against a hand count on a tiny problem,
and the share's edges."""

import pytest

from benchmark import yardstick


def test_fill_work_hand_count():
    # one problem, W = 4 lanes, 3 steps: 12 cells
    ops, nbytes = yardstick.fill_work(cells=12, steps=3, problems=1,
                                      traced=False)
    assert ops == 12 * 14
    assert nbytes == 3 + 16
    ops, nbytes = yardstick.fill_work(cells=12, steps=3, problems=1,
                                      traced=True)
    assert ops == 12 * 20
    assert nbytes == 3 + 16 + 12 * 6 / 8


def test_walk_work_hand_count():
    ops, nbytes = yardstick.walk_work(moves=10, problems=2)
    assert ops == 50
    assert nbytes == 10 + 32


def test_share():
    pk = {"int32_ops_per_s": 1e12, "hbm_bytes_per_s": 1e11}
    # 1e9 ops take 1 ms; 1e7 bytes take 0.1 ms: operations bound it
    assert yardstick.least_seconds(1e9, 1e7, pk) == pytest.approx(1e-3)
    assert yardstick.share(1e9, 1e7, 2e-3, pk) == pytest.approx(50.0)
    assert yardstick.share(1e9, 1e7, 0.0, pk) is None
    assert yardstick.share(0.0, 1e7, 1.0, pk) is None
    pub = yardstick.peaks()
    assert pub["int32_ops_per_s"] == 67e12
    assert pub["hbm_bytes_per_s"] == 3.35e12
