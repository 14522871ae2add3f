"""The golden suite through the port's CLI on the CPU, duo on (the
default), part 3: tags on a circular reference, BAM input with and
without -Q, and BAM tag passthrough (see tests/test_torch_golden_1.py)."""

import pytest

from test_torch_cli import (DATA, _run_cli, one_torch_thread,  # noqa: F401
                            run_golden)


@pytest.mark.parametrize("name", ["circ_tags", "bam", "bam_q"])
def test_golden_duo_on_cpu(name, monkeypatch, tmp_path):
    run_golden(name, monkeypatch, tmp_path)


def test_bam_tag_passthrough_on_cpu(monkeypatch):
    """-T-listed BAM aux tags reach the primary record, with the B-array
    quirk (tests/test_golden_sam.py test_bam_tag_passthrough)."""
    got = _run_cli(["-t1", "-Q", "-TRG,XB", f"{DATA}/tref.fa",
                    f"{DATA}/treads.bam"], monkeypatch)
    assert "RG:Z:grp1" in got
    assert "XB:B:-1,2,300," in got
