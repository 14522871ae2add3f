"""The golden suite through the port's CLI on the CPU, duo on (the
default), part 1: -t4, the tag set with MD, -Q, PAF. The cases are
chip_smoke.GOLDENS's, compared as tests/test_golden_sam.py compares them;
the card runs every golden (chip_smoke.py phase 5)."""

import re

import pytest

from test_torch_cli import DATA, one_torch_thread, run_golden  # noqa: F401

_TAGS = {}


@pytest.mark.parametrize("name", ["t4", "tags", "qual", "paf"])
def test_golden_duo_on_cpu(name, monkeypatch, tmp_path):
    got = run_golden(name, monkeypatch, tmp_path)
    if name == "tags":
        _TAGS["out"] = got


def test_md_truth_on_cpu(monkeypatch, tmp_path):
    """The port's MD equals a recomputation from the CIGAR for every
    record, both strands (tests/test_golden_sam.py test_md_truth)."""
    got = _TAGS.get("out") or run_golden("tags", monkeypatch, tmp_path)
    with open(f"{DATA}/tref.fa") as f:
        ref = "".join(x.strip() for x in f if not x.startswith(">"))
    with open(f"{DATA}/treads.fq") as f:
        ls = f.read().splitlines()
    reads = {ls[i][1:].split()[0]: ls[i + 1] for i in range(0, len(ls), 4)}
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    n_checked = 0
    for line in got.splitlines():
        if line.startswith("@"):
            continue
        rec = line.split("\t")
        flag, pos, cig = int(rec[1]), int(rec[3]), rec[5]
        seq = reads[rec[0]]
        if flag & 16:
            seq = "".join(comp[c] for c in reversed(seq))
        md_field = [x for x in rec if x.startswith("MD:Z:")]
        if not md_field:
            continue
        ri, qi, md, run = pos - 1, 0, [], 0
        for c, op in re.findall(r"(\d+)([MIDSH])", cig):
            c = int(c)
            if op in "SH":
                qi += c
            elif op == "M":
                for _ in range(c):
                    if ref[ri] == seq[qi]:
                        run += 1
                    else:
                        md += [str(run), ref[ri]]
                        run = 0
                    ri += 1
                    qi += 1
            elif op == "D":
                md += [str(run), "^" + ref[ri:ri + c]]
                run = 0
                ri += c
            else:
                qi += c
        md.append(str(run))
        assert md_field[0][5:] == "".join(md), rec[0]
        n_checked += 1
    assert n_checked == 8
