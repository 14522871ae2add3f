"""The golden suite through the port's CLI on the CPU, duo on (the
default), part 5: a multi-sequence reference, a traceback tie, and a
preset read from a config file (see tests/test_torch_golden_1.py)."""

import pytest

from test_torch_cli import (DATA, _run_cli, _strip_pg,  # noqa: F401
                            one_torch_thread, run_golden)


@pytest.mark.parametrize("name", ["multi", "tie"])
def test_golden_duo_on_cpu(name, monkeypatch, tmp_path):
    run_golden(name, monkeypatch, tmp_path)


def test_config_file_preset_on_cpu(monkeypatch, tmp_path):
    """An unknown preset name loads a config file of options
    (tests/test_golden_sam.py test_config_file_preset)."""
    conf = tmp_path / "myconf"
    conf.write_text("-k15 -w10 -a2\n-b4 -p4 -q2 -r3,3 -Y50 -s50 -m0.3\n")
    got = _run_cli(["-t1", "-x", str(conf), f"{DATA}/tref.fa",
                    f"{DATA}/treads.fq"], monkeypatch)
    with open(f"{DATA}/ref_pacbio.sam") as f:
        want = f.read()
    assert _strip_pg(got) == _strip_pg(want)
