"""A whole run of a tiny cell on the CPU, against the plain reference:
correct as it stands, and not correct with the timed path broken
underneath in each way that the cell can break; the run loads no JAX
and no JAX package."""

import json
import subprocess
import sys

import numpy as np

from benchmark.tests import tiny

ROOT = tiny.HERE.rsplit("/", 1)[0]


def test_tiny_run_is_correct_and_loads_no_jax(tmp_path):
    code = (
        "import json, sys\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import run\n"
        f"c, j, r = tiny.run({str(tmp_path)!r}, traced=True)\n"
        "ctx = r['ctx']\n"
        "m = {n: run.read_metric(n, ctx) for n in ('mbases_per_s', "
        "'setup_s', 'host_peak_gb', 'index.build_s', 'io.ms_per_mbase', "
        "'pipeline.self_ms_per_mbase', 'engine.run_ms_per_mbase', "
        "'fill.roofline', 'device.idle_share')}\n"
        "print(json.dumps({'checks': c, 'judged': j, 'metrics': m, "
        "'walk_moves': ctx['counters']['walk_moves'], "
        "'bad': run.forbidden_modules(), 'mods': sorted({k.split('.')[0] "
        "for k in sys.modules})}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["judged"] >= 4
    assert all(v == 0 for v in out["checks"].values()), out["checks"]
    assert out["bad"] == []
    assert "minialign_tpu_torch" in out["mods"]
    for name in ("jax", "jaxlib", "flax", "minialign_tpu"):
        assert name not in out["mods"]
    m = out["metrics"]
    assert m["mbases_per_s"] > 0 and m["setup_s"] > 0
    assert m["index.build_s"] > 0 and m["io.ms_per_mbase"] > 0
    assert m["pipeline.self_ms_per_mbase"] > 0
    # device readings need the card's trace: nothing to read on the CPU
    assert m["fill.roofline"] is None and m["device.idle_share"] is None
    assert out["walk_moves"] > 0


def test_state_left_unchanged_is_caught(tmp_path, monkeypatch):
    """The fill returns its state as it started: nothing extends."""
    from minialign_tpu_torch import extend
    from minialign_tpu_torch.dp.traceback import TraceResult

    def run(self, reqs):
        tr = TraceResult(score=0, alen=0, blen=0, path="", path_rev="",
                         dcnt=0, agcnt=0, bgcnt=0, identity=0.0,
                         gap_penalty=0)
        return [(0, 0, 0, 0, 0, 0, tr) if r[0] == "duo" else
                (0, 0, 0, tr if r[0] == "up" else None) for r in reqs]
    monkeypatch.setattr(extend.FillEngine, "run", run)
    c, j, _ = tiny.run(tmp_path)
    assert j >= 4 and c["unmapped_hi"] > 0


def test_half_the_batch_left_out_is_caught(tmp_path, monkeypatch):
    """align_batch maps the first half of each batch and drops the rest."""
    from minialign_tpu_torch import pipeline
    orig = pipeline.align_batch

    def half(mp, mi, reads, *a, **kw):
        return orig(mp, mi, reads[:max(1, len(reads) // 2)], *a, **kw)
    monkeypatch.setattr(pipeline, "align_batch", half)
    c, j, _ = tiny.run(tmp_path)
    assert c["missing"] > 0


def test_answer_altered_where_produced_is_caught(tmp_path, monkeypatch):
    """Each primary alignment is moved one base along the reference."""
    from minialign_tpu_torch import pipeline
    orig = pipeline.align_batch

    def shifted(*a, **kw):
        regs = orig(*a, **kw)
        for reg in regs:
            if reg is not None:
                aln = reg.alns[0].aln
                for s in aln.segs:
                    s.as0 += 1
                    s.ae += 1
        return regs
    monkeypatch.setattr(pipeline, "align_batch", shifted)
    c, j, _ = tiny.run(tmp_path)
    assert c["seg_gap"] > 0 or c["malformed"] > 0


def test_index_fault_is_caught(tmp_path, monkeypatch):
    """An index that lost every tenth entry's strand."""
    from minialign_tpu_torch import cli
    orig = cli._iter_index_blocks

    def bad(*a, **kw):
        for mi in orig(*a, **kw):
            mi.vals_rid = mi.vals_rid.copy()
            mi.vals_rid[::10] ^= np.uint32(1)
            yield mi
    monkeypatch.setattr(cli, "_iter_index_blocks", bad)
    c, j, _ = tiny.run(tmp_path)
    assert c["index_diff"] > 0
