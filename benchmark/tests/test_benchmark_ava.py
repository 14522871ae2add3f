"""The all-vs-all overlap cell (modes/ava.py, reference_ava.py,
control_ava.py, yardstick_linear.py and its three metrics) on the CPU, at
a size the plain fill runs in seconds: the tiny cell is correct through
the frame and reads its program metrics; each of the judge's checks fires
on the timed path's output broken for it; the control in int16 comes out
not correct and in int32 correct; the limits file is the mode's."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import gen, reference as R, reference_ava as RA, run, spec
from benchmark import window, yardstick, yardstick_linear
from benchmark.modes import ava
from benchmark.tests import tiny

ROOT = os.path.dirname(tiny.HERE)
CELL = "ecoli-pacbio-ava.overlap"
SEED = 2**31 + 29


def ava_cell(genome=2600, coverage=1.8):
    """The ecoli-pacbio-ava configuration and the overlap mix cut to four
    reads of ~1.15 kb at 0.97 on a 2.6 kb genome: some pairs overlap,
    some do not."""
    b = spec.benchmark()
    _, _, cfg, mix = spec.cell(b, CELL)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["genome"]["length"] = genome
    cfg["coverage"] = coverage
    cfg["reads"].update(len_mean=1150, len_sd=30, acc_mean=0.97, acc_sd=0.01,
                        acc_min=0.95)
    mix["warmup_bases"] = 100
    return cfg, mix


@pytest.fixture(scope="module")
def mode(tmp_path_factory):
    """The mode's hooks in the frame's order on the CPU, one batch, the
    warm-up left out: the Mode, with its records, paths and index."""
    import torch
    os.environ["MINIALIGN_SCHED_WORKERS"] = "1"
    torch.set_num_threads(1)
    cfg, mix = ava_cell()
    m = spec.mode(mix).Mode(cfg, mix, SEED, "cpu",
                            str(tmp_path_factory.mktemp("ava")),
                            sample=(6, 2), n_blocks=4)
    m.inputs()
    m.prepare()
    m.index()
    m.engine()
    m.writer(run.Sink())
    batches, process = m.open_window(run.Spans(), {}, False)
    window.run(batches, process, 0.0)
    m.end_window({})
    return m


def _judge(m, records=None, paths=None, index=None, **kw):
    return ava.judge(m.cfg["score"], m.pool, m.picks, m.seen,
                     m.records if records is None else records,
                     m.paths if paths is None else paths,
                     gen._rng(m.seed, 4),
                     index=m.mi if index is None else index, k=15, w=5,
                     n_reads=4, **kw)


def test_the_tiny_cell_is_correct_and_has_work_to_judge(mode):
    m = mode
    assert len(m.pool) == 4 and sorted(m.picks) == [0, 1, 2, 3]
    v, judged, failed = _judge(m)
    assert judged == 4 and failed == 0
    assert v == dict.fromkeys(ava.CHECKS, 0), v
    pairs = [(i, o["j"]) for i in range(4)
             for o in RA.true_overlaps(m.pool, i)]
    assert pairs and len(pairs) < 12         # some pairs overlap, not all
    assert sum(len(p) for p in m.paths.values()) == len(pairs)


def _edit(records, fn):
    return {i: "".join(fn(i, line) for line in t.splitlines(True))
            for i, t in records.items()}


def _fields(fn):
    def edit(i, line):
        f = line.rstrip("\n").split("\t")
        return "\t".join(fn(i, f)) + "\n"
    return edit


def test_lines_dropped_are_missing_and_missed(mode, monkeypatch):
    m = mode
    monkeypatch.setattr(ava, "MISSED_MIN_BASES", 300)
    recs = dict(m.records)
    recs[0] = ""
    v, _, failed = _judge(m, records=recs)
    assert v["missing"] == 1 and failed == 1
    others = _edit(m.records, lambda i, x: x if x.split("\t")[5] == f"r{i}"
                   else "")
    v, _, _ = _judge(m, records=others)
    assert v["missed_overlap"] > 0 and v["missing"] == 0


def test_a_target_swapped_is_a_false_overlap(mode):
    m = mode
    far = {i: next(j for j in range(4) if j != i and j not in
                   {o["j"] for o in RA.true_overlaps(m.pool, i)})
           for i in range(4) if len(RA.true_overlaps(m.pool, i)) < 3}
    lens = {j: int(RA.read_map(m.pool, j)[-1]) for j in range(4)}

    def swap(i, f):
        if i in far and f[5] != f"r{i}":
            j = far[i]
            f[5], f[6] = f"r{j}", str(lens[j])
            f[7], f[8] = "0", str(min(int(f[8]) - int(f[7]), lens[j]))
        return f
    v, _, failed = _judge(m, records=_edit(m.records, _fields(swap)),
                          paths={})
    # the preset prints false overlaps of its own: such a line fails no
    # read, its count has a limit
    assert v["false_overlap"] > 0 and failed == 0


def test_a_strand_flipped_is_a_false_overlap(mode):
    m = mode

    def flip(i, f):
        if f[5] != f"r{i}":
            f[4] = "+" if f[4] == "-" else "-"
        return f
    v, _, _ = _judge(m, records=_edit(m.records, _fields(flip)), paths={})
    assert v["false_overlap"] > 0


def _correct(v):
    lim = spec.limits(CELL)
    return all(x <= lim[k] for k, x in v.items())


def test_query_coordinates_left_unflipped_on_minus_lines(mode):
    """A writer that prints a '-' line's query span on the query as
    written, not on its reverse complement: the judged paths are not
    their lines (malformed, so not correct), and the lines alone lie off
    their pairs' true alignments (false_overlap)."""
    m = mode
    n = 0

    def unflip(i, f):
        nonlocal n
        if f[5] != f"r{i}" and f[4] == "-":
            qlen, qs, qe = int(f[1]), int(f[2]), int(f[3])
            f[2], f[3] = str(qlen - qe), str(qlen - qs)
            n += 1
        return f
    recs = _edit(m.records, _fields(unflip))
    assert n > 0
    v, _, failed = _judge(m, records=recs)
    assert v["malformed"] > 0 and failed > 0 and not _correct(v)
    v, _, _ = _judge(m, records=recs, paths={})
    assert v["false_overlap"] > 0 and v["malformed"] == 0


def test_target_coordinates_offset_are_off_the_diagonal(mode):
    """Each non-self line's target span moved 2 x DIAG_SLACK bases, the
    way that keeps it on the target: every such line is a false overlap,
    and the judged paths are not their lines."""
    m = mode
    d, n = 2 * ava.DIAG_SLACK, 0

    def offset(i, f):
        nonlocal n
        ts, te, tlen = int(f[7]), int(f[8]), int(f[6])
        if f[5] != f"r{i}" and (te + d <= tlen or ts >= d):
            s = d if te + d <= tlen else -d
            f[7], f[8] = str(ts + s), str(te + s)
            n += 1
        return f
    recs = _edit(m.records, _fields(offset))
    assert n > 0
    v, _, _ = _judge(m, records=recs, paths={})
    assert v["false_overlap"] == n
    v, _, failed = _judge(m, records=recs)
    assert v["malformed"] > 0 and failed > 0 and not _correct(v)


def test_spans_swapped_between_two_lines(mode):
    """Two non-self lines of a read trade their spans: the judged paths
    are not their lines."""
    m = mode
    recs, n = dict(m.records), 0
    for i, t in m.records.items():
        lines = t.splitlines()
        k = [x for x, line in enumerate(lines)
             if line.split("\t")[5] != f"r{i}"]
        if len(k) < 2:
            continue
        a, b = (lines[x].split("\t") for x in k[:2])
        for c in (2, 3, 7, 8):
            a[c], b[c] = b[c], a[c]
        lines[k[0]], lines[k[1]] = "\t".join(a), "\t".join(b)
        recs[i] = "\n".join(lines) + "\n"
        n += 1
    assert n > 0
    v, _, failed = _judge(m, records=recs)
    assert v["malformed"] > 0 and failed > 0 and not _correct(v)


def test_a_self_line_cut_short_and_a_line_cut_off(mode):
    m = mode

    def short(i, f):
        if f[5] == f"r{i}":
            f[3] = str(int(f[3]) - 1)
        return f
    v, _, _ = _judge(m, records=_edit(m.records, _fields(short)))
    assert v["self_short"] == 4
    v, _, _ = _judge(m, records=_edit(
        m.records, _fields(lambda i, f: f[:11])))
    assert v["malformed"] > 0


def test_a_path_perturbed_is_a_seg_gap(mode):
    """In each judged path, a run of 20 matches becomes an insertion, 19
    matches and a deletion: the same two ends, a worse path between."""
    m = mode
    paths = copy.deepcopy(m.paths)
    n = 0
    for recs in paths.values():
        for p in recs:
            ops = [f"{c}{op}" for c, op in R.parse_cigar(p["cigar"])]
            for k, op in enumerate(ops):
                if op.endswith("M") and int(op[:-1]) >= 40:
                    ops[k] = f"{int(op[:-1]) - 20}M1I19M1D"
                    n += 1
                    break
            p["cigar"] = "".join(ops)
    assert n > 0
    v, _, _ = _judge(m, paths=paths)
    assert v["seg_gap"] > 0 and v["malformed"] == 0


def test_an_index_entry_changed_is_an_index_diff(mode):
    m = mode
    bad = copy.copy(m.mi)
    bad.vals_rid = m.mi.vals_rid.copy()
    bad.vals_rid[::10] ^= np.uint32(1)
    v, _, _ = _judge(m, index=bad)
    assert v["index_diff"] > 0


def test_through_the_frame_correct_and_program_metrics_read(tmp_path):
    """The tiny cell through run_cell, traced, with the recorder told that
    a profiler records (as test_benchmark_spans does): correct, and the
    PAF writer's span and the alignment counter read as numbers."""
    cfg, mix = ava_cell()
    code = (
        "import json, os\n"
        "os.environ['MINIALIGN_SCHED_WORKERS'] = '1'\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from minialign_tpu_torch import stats\n"
        "from benchmark import run\n"
        "stats._profiling = lambda: True\n"
        f"r = run.run_cell({cfg!r}, {mix!r}, {SEED}, 0.0, True, 'cpu', "
        f"{str(tmp_path)!r}, sample=(6, 2), n_blocks=4)\n"
        "names = ('io.paf_format_ms_per_mbase', 'pipeline.alns_per_read', "
        "'fill.linear_roofline', 'mbases_per_s')\n"
        "m = {n: run.read_metric(n, r['ctx']) for n in names}\n"
        "print(json.dumps({'checks': r['checks'], 'judged': r['judged'], "
        "'metrics': m, 'bad': run.forbidden_modules()}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["judged"] == 4 and out["bad"] == []
    assert all(v == 0 for v in out["checks"].values()), out["checks"]
    m = out["metrics"]
    assert m["io.paf_format_ms_per_mbase"] > 0
    assert m["pipeline.alns_per_read"] >= 1.5
    # a device trace only on the card
    assert m["fill.linear_roofline"] is None and m["mbases_per_s"] > 0


def test_fill_linear_roofline_reads_a_trace():
    c = {f"fill_{a}.{b}": n for a, n in (("cells", 6400), ("steps", 100),
                                         ("problems", 2))
         for b in ("untraced", "traced")}
    ctx = {"trace": {"by_layer": {"fill": 1e-6}}, "counters": c}
    got = run.read_metric("fill.linear_roofline", ctx)
    ops, nbytes = 6400 * 6 + 6400 * 8, 2 * (100 + 2 * 16) + 6400 * 2 / 8
    pk = yardstick.peaks()
    assert got == pytest.approx(100 * yardstick.least_seconds(ops, nbytes, pk)
                                / 1e-6)
    assert run.read_metric("fill.linear_roofline",
                           {"trace": None, "counters": c}) is None


def test_fill_work_linear_hand_count():
    # one problem, W = 4 lanes, 3 steps: 12 cells
    assert yardstick_linear.fill_work_linear(12, 3, 1, False) == (
        12 * 6, 3 + 16)
    assert yardstick_linear.fill_work_linear(12, 3, 1, True) == (
        12 * 8, 3 + 16 + 12 * 2 / 8)


def test_limits_are_the_modes_checks():
    b = spec.benchmark()
    _, _, _, mix = spec.cell(b, CELL)
    lim = spec.limits(CELL, spec.mode(mix).CHECKS)
    assert set(lim) == set(ava.CHECKS)


def _long_cell():
    """Four reads of 30 kb at 0.95 on a 34 kb genome: every pair overlaps
    by >= 26 kb, so a path's score passes the int16 range ~20 kb in (as
    the card's cell does on its longest, most accurate pairs); past it a
    saturated path takes a gap for each mismatch."""
    cfg, mix = ava_cell(genome=34_000, coverage=3.53)
    cfg["reads"].update(len_mean=30_000, len_sd=10, acc_mean=0.95,
                        acc_sd=0.001, acc_min=0.94)
    return cfg, mix


def test_control_int16_fails_and_int32_passes_on_cpu():
    from benchmark import control_ava
    cfg, mix = _long_cell()
    lim = spec.limits(CELL)
    v16, j16, _ = control_ava.control(cfg, mix, 11, True, "cpu",
                                      sample=(4, 0))
    v32, j32, _ = control_ava.control(cfg, mix, 11, False, "cpu",
                                      sample=(4, 0))
    assert j16 == j32 == 4
    assert all(v32[k] <= lim[k] for k in v32), v32
    assert v16["seg_gap"] > lim["seg_gap"], v16
