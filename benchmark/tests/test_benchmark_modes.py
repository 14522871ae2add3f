"""A cell's traffic mode as a file of its own (modes/<mode>.py): the map
mode does what the harness did before it was a file (the tiny cell's
output, checks and counts as recorded on the harness before the move);
a mode with no file, or limits that are not the mode's checks, stop a
run before any input is written; and an all-vs-all mode that lives only
here (ava_mode.py) runs through the frame as it stands."""

import copy
import os
import re

import pytest

from benchmark import run, spec
from benchmark.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))

# The tiny cell, one batch (seconds 0), work directory "w" (the SAM's @PG
# line holds the input paths): output bytes and sha256, reads and bases
# of the window, and a traced run's counters, as the harness gave them
# before the move (commit e98480f). Every check read 0, 6 reads judged.
BEFORE = {
    2**31 + 7: (16008, "966d6165f29427f492673fd05e10b78f6d7d3ce066a6eb7ac5f9"
                "e0a2de0931f5", 6, 11981,
                (23959, 6, 1024, 24192, 65536, 1548288, 6, 6)),
    5: (15853, "94dffa618e23cee5dd96ae477a0119c3d8b535d15a5feb60fe44be4077"
        "132cfb", 6, 11972, (23970, 6, 1408, 24224, 90112, 1550336, 7, 7)),
    3300000077: (15925, "2c72a8ff57c97f8a794ae843f4f55b5dcdb2b87c1fc9fa3984"
                 "bd81ed8e37b322", 6, 12006,
                 (23976, 6, 1920, 24192, 122880, 1548288, 6, 6)),
}
COUNTERS = ("walk_moves", "walk_problems", "fill_steps.untraced",
            "fill_steps.traced", "fill_cells.untraced", "fill_cells.traced",
            "fill_problems.untraced", "fill_problems.traced")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("seed", sorted(BEFORE))
def test_map_mode_equals_the_harness_before_the_move(tmp_path, monkeypatch,
                                                     seed, traced):
    monkeypatch.chdir(tmp_path)
    os.mkdir("w")
    c, j, r = tiny.run("w", seed=seed, traced=traced)
    nbytes, sha, reads, bases, counts = BEFORE[seed]
    w = r["ctx"]["window"]
    assert (r["out_bytes"], r["out_sha256"]) == (nbytes, sha)
    assert (w.batches, w.reads, w.bases) == (1, reads, bases)
    assert j == 6 and c == dict.fromkeys(spec.mode(tiny.cell()[1]).CHECKS, 0)
    if traced:
        got = r["ctx"]["counters"]
        assert tuple(got[k] for k in COUNTERS) == counts
        assert (got["fill_launches"], got["fill_problems"]) == (0, 0)


def _no_set_up(tmp_path, monkeypatch):
    """run_cell and the temporary directory that would hold the inputs
    fail if reached."""
    def never(*a, **kw):
        raise AssertionError("set-up was reached")
    monkeypatch.setattr(run, "run_cell", never)
    monkeypatch.setattr(run.tempfile, "TemporaryDirectory", never)


ARGS = ["--workload", "ecoli-pacbio.map", "--seed", "3", "--seconds", "1"]


def test_mode_without_a_file_stops_before_set_up(tmp_path, monkeypatch):
    monkeypatch.setattr(spec, "MODES", str(tmp_path / "modes"))
    _no_set_up(tmp_path, monkeypatch)
    with pytest.raises(spec.SpecError, match="has no file"):
        run.main(ARGS)
    monkeypatch.undo()
    # run_cell itself: nothing written into the work directory
    monkeypatch.setattr(spec, "MODES", str(tmp_path / "modes"))
    (tmp_path / "wd").mkdir()
    cfg, mix = tiny.cell()
    with pytest.raises(spec.SpecError, match="has no file"):
        run.run_cell(cfg, mix, 3, 0.0, False, "cpu", str(tmp_path / "wd"))
    assert os.listdir(tmp_path / "wd") == []


@pytest.mark.parametrize("change", ["extra", "missing"])
def test_limits_other_than_the_checks_stop_before_set_up(tmp_path,
                                                         monkeypatch, change):
    load = spec.load_json

    def edited(rel):
        d = load(rel)
        if rel.startswith(os.path.join("benchmark", "limits")):
            lim = dict(d["limits"])
            if change == "extra":
                lim["seg_gap_extra"] = 1
            else:
                del lim["seg_gap"]
            d = dict(d, limits=lim)
        return d
    monkeypatch.setattr(spec, "load_json", edited)
    _no_set_up(tmp_path, monkeypatch)
    with pytest.raises(spec.SpecError, match="the mode's checks"):
        run.main(ARGS)


def test_every_cell_finds_its_mode_and_the_frame_names_none():
    b = spec.benchmark()
    for w in b["workloads"]:
        _, _, _, mix = spec.cell(b, w["name"])
        spec.limits(w["name"], spec.mode(mix).CHECKS)
    with open(run.__file__) as f:
        src = f.read()
    assert not re.search(r"[\"']map[\"']|modes\.map|import map", src)


def _ava_cell():
    cfg, mix = tiny.cell()
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["genome"]["length"] = 4000
    cfg["reads"].update(len_mean=1050, len_sd=100, acc_mean=0.95,
                        acc_sd=0.01)
    mix.update(mode="ava_mode", pool_mbases=0.0063, warmup_bases=1000)
    return cfg, mix


def test_ava_mode_runs_through_the_frame(tmp_path, monkeypatch):
    """Six reads of ~1 kb at 0.95 on a 4 kb genome, each overlapping
    others: every read has a PAF line, and an overlap with another read
    drawn from the same place."""
    monkeypatch.setattr(spec, "MODES", HERE)
    c, j, r = tiny.run(tmp_path, cfg_mix=_ava_cell())
    assert j == 6 and c == {"missing": 0, "no_true_overlap": 0}
    assert r["ctx"]["window"].reads == 6 and r["out_bytes"] > 0


def test_ava_mode_catches_half_the_batch_left_out(tmp_path, monkeypatch):
    from minialign_tpu_torch import pipeline
    orig = pipeline.align_batch

    def half(mp, mi, reads, *a, **kw):
        return orig(mp, mi, reads[:max(1, len(reads) // 2)], *a, **kw)
    monkeypatch.setattr(pipeline, "align_batch", half)
    monkeypatch.setattr(spec, "MODES", HERE)
    c, j, _ = tiny.run(tmp_path, cfg_mix=_ava_cell())
    assert j == 6 and c["missing"] >= 3
