"""The golden suite through the port's CLI on the CPU, part 4: the ONT
presets (one on a circular reference), a score-matrix modifier, and
ref_out with MINIALIGN_DUO=0, the two-step path (see
tests/test_torch_golden_1.py)."""

import pytest

from test_torch_cli import one_torch_thread, run_golden  # noqa: F401


@pytest.mark.parametrize("name", ["ont", "emod", "ont1dsq_circ"])
def test_golden_duo_on_cpu(name, monkeypatch, tmp_path):
    run_golden(name, monkeypatch, tmp_path)


def test_golden_duo_off_on_cpu(monkeypatch, tmp_path):
    run_golden("out", monkeypatch, tmp_path, duo="0")
