"""pipeline.lane_hit_share (metrics/pipeline.lane_hit_share.py): the
share of the read passes' extension requests answered from the lane memo,
read from the program's counters through program.py as a traced window
holds them; 0 where no read was laned; nothing from a program without
the counters, or from an untraced run."""

import time

import pytest

from benchmark import program, run


class _Window:
    bases = 10**6

    def __init__(self, t0, t1):
        self.t0, self.t1 = t0, t1


@pytest.fixture
def recorded():
    """The port's recorder on, emptied before and after; yields a function
    that records one span and the given counters inside a window and
    returns the ctx a traced run hands the metric readers."""
    from minialign_tpu_torch import stats
    stats.stop()
    stats.reset()
    program._memo.clear()

    def record(**counters):
        stats.start()
        t0 = time.perf_counter()
        sp = stats.begin("pipeline.extend")
        for name, n in counters.items():
            stats.add("pipeline." + name, n)
        stats.end(sp)
        stats.stop()
        return {"traced": True, "window": _Window(t0, time.perf_counter())}
    yield record
    stats.stop()
    stats.reset()
    program._memo.clear()


def test_share_of_requests_answered_from_the_memo(recorded):
    ctx = recorded(ext_reqs=400, lane_hits=388, lane_reads=7, lane_unused=5)
    assert run.read_metric("pipeline.lane_hit_share", ctx) == \
        pytest.approx(97.0)


def test_no_laned_read_reads_zero(recorded):
    ctx = recorded(ext_reqs=120, lane_hits=0, lane_reads=0, lane_unused=0)
    assert run.read_metric("pipeline.lane_hit_share", ctx) == 0.0


def test_without_the_counters_reads_nothing(recorded):
    ctx = recorded(reads=12, replays=1)
    assert run.read_metric("pipeline.lane_hit_share", ctx) is None
    ctx = recorded(ext_reqs=0, lane_hits=0)
    assert run.read_metric("pipeline.lane_hit_share", ctx) is None
    assert run.read_metric("pipeline.lane_hit_share",
                           {"traced": False}) is None
