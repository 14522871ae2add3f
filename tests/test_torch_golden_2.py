"""The golden suite through the port's CLI on the CPU, duo on (the
default), part 2: MAF, BLAST6, a circular reference in SAM and PAF (see
tests/test_torch_golden_1.py)."""

import pytest

from test_torch_cli import one_torch_thread, run_golden  # noqa: F401


@pytest.mark.parametrize("name", ["maf", "blast6", "circ", "circ_paf"])
def test_golden_duo_on_cpu(name, monkeypatch, tmp_path):
    run_golden(name, monkeypatch, tmp_path)
