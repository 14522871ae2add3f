"""The port's prewarm entry point (python -m minialign_tpu_torch.prewarm,
the copy of minialign_tpu/prewarm.py) and the engine's MINIALIGN_STATS
counters (minialign_tpu_torch.extend.FillEngine, as
minialign_tpu/extend.py:307-325, :965-967 and :1033-1035 keep them), on
the CPU engine in subprocesses: prewarm exits 0 with its stderr line;
with MINIALIGN_STATS=1 the [stats] lines at exit count exactly the
engine's traced launch batches (the walk on the device) and duo batches,
nreal being the problem count rounded up to 16 and B the launch's own;
without the variable the recorder that keeps them (stats.py) is off."""

import collections
import json
import os
import re
import subprocess
import sys

import pytest

from minialign_tpu_torch.extend import FillEngine
from minialign_tpu_torch.params import MapParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the prewarm's map with the engine's batches counted around the calls
# that launch them: a duo batch (_duo_batch) and a traced batch of ups
# walked on the device (dtrace in FillEngine.run; a duo batch's own walk
# is counted out)
CHILD = r"""
import collections, json, sys
from minialign_tpu_torch import extend, prewarm
from minialign_tpu_torch.extend import FillEngine
seen = collections.Counter()
in_duo = []
duo_batch, dtrace = FillEngine._duo_batch, extend.dtrace

def counted_duo(self, reqs, W):
    seen[("duo", len(reqs))] += 1
    in_duo.append(1)
    try:
        return duo_batch(self, reqs, W)
    finally:
        in_duo.pop()

def counted_dtrace(p, W, masks, *a, **kw):
    if not in_duo:
        seen[("trace", masks.shape[0])] += 1
    return dtrace(p, W, masks, *a, **kw)

FillEngine._duo_batch = counted_duo
extend.dtrace = counted_dtrace
rc = prewarm.main(sys.argv[1:])
print("SEEN " + json.dumps(sorted([k, b, n] for (k, b), n in seen.items())))
sys.exit(rc)
"""


def run(args, **env):
    e = dict(os.environ, MINIALIGN_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    e.pop("MINIALIGN_STATS", None)
    e.update(env)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=e,
                          capture_output=True, text=True, timeout=600)


def test_prewarm_module_entry_exits_0_on_the_cpu():
    r = run(["-m", "minialign_tpu_torch.prewarm", "300", "200"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == ""
    line = [x for x in r.stderr.splitlines() if "prewarm done" in x]
    assert len(line) == 1, r.stderr[-2000:]
    assert re.search(r"prewarm done in [\d.]+ s \(lengths \[300, 200\], opts "
                     r"\['<default>'\]; build [\d.]+ s\)", line[0]), line


@pytest.mark.parametrize("duo", ("1", "0"))
def test_stats_lines_count_the_engine_batches(duo):
    r = run(["-c", CHILD, "300", "200", "600"], MINIALIGN_STATS="1",
            MINIALIGN_DUO=duo)
    assert r.returncode == 0, r.stderr[-2000:]
    seen = [x for x in r.stdout.splitlines() if x.startswith("SEEN ")]
    assert len(seen) == 1, r.stdout[-2000:]
    want = collections.Counter()
    for kind, B, n in json.loads(seen[0][5:]):
        want[(kind, -(-B // 16) * 16, B)] += n
    got = collections.Counter()
    for m in re.finditer(r"^\[stats\] (\w+) nreal=(\d+) B=(\d+) x(\d+)$",
                         r.stderr, re.M):
        got[(m[1], int(m[2]), int(m[3]))] += int(m[4])
    assert got == want
    kinds = {k for k, _, _ in got}
    assert kinds == ({"duo"} if duo == "1" else {"trace"}), got


def test_no_stats_without_the_variable(monkeypatch):
    """The launch shapes live in the recorder (stats.py), which only the
    variable (or a profiler, or start()) turns on."""
    from minialign_tpu_torch import stats
    monkeypatch.delenv("MINIALIGN_STATS", raising=False)
    was = stats.ON
    try:
        stats.stop()
        stats.reset()
        assert not stats.from_env() and not stats.ON
        FillEngine(MapParams().score, device="cpu")
        assert stats.read()["launch_shapes"] == []
        monkeypatch.setenv("MINIALIGN_STATS", "1")
        assert stats.from_env() and stats.ON
        assert stats.read()["launch_shapes"] == []
    finally:
        stats.stop()
        stats.reset()
        if was:
            stats.start()
