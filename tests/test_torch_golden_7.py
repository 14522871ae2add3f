"""The golden suite through the port's CLI on the CPU, duo on (the
default), part 7: origin-wrapping alignments in SAM (see
tests/test_torch_golden_1.py)."""

from test_torch_cli import one_torch_thread, run_golden  # noqa: F401


def test_golden_circsplit_duo_on_cpu(monkeypatch, tmp_path):
    run_golden("circsplit", monkeypatch, tmp_path)
