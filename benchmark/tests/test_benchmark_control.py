"""The control: the plain reference put in the program's place. In
saturating int16 it has to come out not correct; in int32 correct. On
the CPU at a size a test run holds (six reads of ~30 kb at 0.90, whose
scores pass 32,767 two thirds of the way); on the card at the cells'
own size."""

import copy
import json
import os
import subprocess
import sys

import pytest

from benchmark import control, spec
from benchmark.tests import tiny


def _long_cell():
    cfg, mix = tiny.cell()
    cfg = copy.deepcopy(cfg)
    cfg["genome"]["length"] = 300_000
    cfg["reads"].update(len_mean=30_000, len_sd=10, acc_mean=0.90,
                        acc_sd=0.001)
    mix["pool_mbases"] = 0.18
    return cfg, mix


def test_control_int16_fails_and_int32_passes_on_cpu():
    cfg, mix = _long_cell()
    lim = spec.limits("ecoli-pacbio.map")
    v16, j16, _ = control.control(cfg, mix, 11, True, "cpu", sample=(6, 2))
    v32, j32, _ = control.control(cfg, mix, 11, False, "cpu", sample=(6, 2))
    assert j16 == j32 == 6
    assert all(v32[k] <= lim[k] for k in v32), v32
    assert v16["seg_gap"] > lim["seg_gap"], v16


@pytest.mark.cuda
def test_control_at_cell_size_on_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control at the cells' size runs "
                    "on the card")
    root = os.path.dirname(tiny.HERE)
    for cell in ("ecoli-pacbio.map", "dm6-10k.map"):
        p = subprocess.run([sys.executable, "-m", "benchmark.control",
                            "--workload", cell, "--seeds", "1,2,3",
                            "--int32"], cwd=root, capture_output=True,
                           text=True, timeout=1800)
        assert p.returncode == 0, p.stderr[-2000:]
        rows = [json.loads(x) for x in p.stdout.splitlines()]
        assert all(not r["correct"] for r in rows
                   if r["precision"] == "int16"), rows
        assert all(r["correct"] for r in rows
                   if r["precision"] == "int32"), rows


@pytest.mark.cuda
def test_tiny_cell_on_card(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run on the card")
    from benchmark import run
    cfg, mix = tiny.cell()
    r = run.run_cell(cfg, mix, 5, 0.0, True, "cuda", str(tmp_path),
                     sample=(6, 2), n_blocks=4)
    assert r["judged"] >= 4
    assert all(v == 0 for v in r["checks"].values()), r["checks"]
    assert r["ctx"]["trace"]["busy_s"] > 0
    assert run.read_metric("fill.roofline", r["ctx"]) is not None
