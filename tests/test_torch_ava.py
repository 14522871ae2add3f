"""All-vs-all overlap (-t1 -X -xava -Opaf) through the port's CLI in this
process on the CPU, held against the plain reference of the benchmark's
overlap cell (benchmark/reference_ava.py, judged by benchmark/modes/ava.py
as a run of the cell is): every read has its lines, well formed, its whole
self hit, only true overlaps on the right strand, paths that are the best
under the linear gap model between any two of their points, an index that
holds exactly the reads' minimizers, and a line for every true overlap of
>= 1 kb; the PAF writer's io.format spans, the pipeline.alns counter and
the lane counters are recorded under MINIALIGN_STATS.

The size is the CPU's: the plain fill runs ~5 s a round of the engine
here, so three reads of ~1.15 kb on a 1.35 kb genome, every pair
overlapping by ~1 kb."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import gen, reference_ava as RA  # noqa: E402
from benchmark.modes import ava  # noqa: E402

SEED = 2**31 + 20
GENOME = 1350
SCORE = {"matrix": [2, -3, -3, -3, -3, 2, -3, -3, -3, -3, 2, -3, -3, -3, -3,
                    2],
         "gi": 0, "ge": 2, "gfa": 0, "gfb": 0, "model": "LINEAR"}
READS = {"len_mean": 1150, "len_sd": 30, "len_min": 500, "acc_mean": 0.97,
         "acc_sd": 0.02, "acc_min": 0.92, "acc_max": 0.999,
         "error_split": [0.4, 0.3, 0.3]}


@pytest.fixture(scope="module")
def overlap(tmp_path_factory):
    """The pool, the CLI's PAF, each read's Reg, and what the recorder
    held."""
    from minialign_tpu_torch import cli, stats
    from minialign_tpu_torch.io import sam
    pool = gen.Pool.make(SEED, gen.genome(SEED, GENOME), READS, 3450)
    fq = str(tmp_path_factory.mktemp("ava") / "reads.fq")
    pool.write_fastq(fq)
    regs, mis = {}, []
    mapped = sam.PafWriter.mapped
    blocks = cli._iter_index_blocks

    def keep(self, ref_names, ref_lens, ref_codes, seq, reg):
        regs[int(seq.name[1:])] = reg
        mapped(self, ref_names, ref_lens, ref_codes, seq, reg)

    def kept_blocks(*a, **kw):
        for mi in blocks(*a, **kw):
            mis.append(mi)
            yield mi
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MINIALIGN_TORCH_DEVICE", "cpu")
        mp.setenv("MINIALIGN_STATS", "1")
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.delenv("MINIALIGN_PROC_WORKERS", raising=False)
        mp.setattr(sam.PafWriter, "mapped", keep)
        mp.setattr(cli, "_iter_index_blocks", kept_blocks)
        stats.stop()
        stats.reset()
        assert stats.from_env()
        try:
            from test_torch_cli import cli_run
            out, rc = cli_run(["-t1", "-X", "-xava", "-Opaf", fq])
            rec = stats.read()
        finally:
            stats.stop()
            stats.reset()
            torch.set_num_threads(n)
    assert rc == 0 and len(mis) == 1
    return pool, out, regs, mis[0], rec


def _records(pool, out):
    text = {}
    for line in out.splitlines(keepends=True):
        i = int(line.split("\t", 1)[0][1:])
        text[i] = text.get(i, "") + line
    return text


def _paths(regs):
    from minialign_tpu_torch.io.sam import seg_cigar
    return {i: ava.path_records(i, reg, seg_cigar) for i, reg in regs.items()}


def test_overlaps_hold_against_the_plain_reference(overlap):
    pool, out, regs, mi, _ = overlap
    picks = list(range(len(pool)))
    v, judged, failed = ava.judge(
        SCORE, pool, picks, set(picks), _records(pool, out), _paths(regs),
        gen._rng(SEED, 4), index=mi, k=15, w=5, n_reads=len(pool))
    assert judged == len(pool) == 3 and failed == 0
    assert v == dict.fromkeys(ava.CHECKS, 0), v
    # the judge saw paths and index entries: a line per true overlap
    n_paths = sum(1 for p in _paths(regs).values() for _ in p)
    assert n_paths >= 4


def test_every_true_overlap_of_1kb_is_found(overlap):
    pool, out, _, _, _ = overlap
    printed = {(int(f[0][1:]), int(f[5][1:]))
               for f in (x.split("\t") for x in out.splitlines())}
    want = {(i, o["j"]) for i in range(len(pool))
            for o in RA.true_overlaps(pool, i) if o["glen"] >= 1000}
    assert want and want <= printed, sorted(want - printed)


def test_paf_format_spans_and_alignment_counter(overlap):
    pool, out, regs, _, rec = overlap
    n_lines = len(out.splitlines())
    assert rec["spans"]["io.format"]["count"] == len(pool)
    assert rec["counters"]["pipeline.reads"] == len(pool)
    assert rec["counters"]["pipeline.alns"] == n_lines == sum(
        len(r.alns) for r in regs.values() if r is not None)


def test_overlapping_reads_are_laned_and_answered_from_the_memo(overlap):
    """Each read chains on itself and on the reads that overlap it, so its
    chains fall on two or more targets and run as lanes; the passes'
    requests are answered from the lane memo (MINIALIGN_STATS counters)."""
    pool, _, _, _, rec = overlap
    c = rec["counters"]
    assert c["pipeline.lane_reads"] == len(pool)
    assert 0 < c["pipeline.lane_hits"] <= c["pipeline.ext_reqs"]
    assert c["pipeline.lane_unused"] >= 0


def test_read_map_places_every_kept_base():
    """reference_ava.read_map against the generator's own reads: each
    source base that the first draw neither deleted nor substituted sits
    where the map puts it, and the map's end is the read's length."""
    pool = gen.Pool.make(SEED, gen.genome(SEED, GENOME), READS, 3450)
    for i in range(len(pool)):
        pm = RA.read_map(pool, i)
        read = pool.codes(i)
        fw = (3 - read[::-1]) if pool.rev[i] else read
        assert pm[-1] == len(read)
        st, n = int(pool.start[i]), int(pool.length[i])
        err = 1.0 - float(pool.acc[i])
        r = gen._rng(SEED, 2, i).random(n)
        exact = np.flatnonzero((np.diff(pm) > 0) & (r >= err * 0.4))
        assert len(exact) > n // 2
        assert (fw[pm[exact]] == pool.genome[st:st + n][exact]).all()


def test_linear_score_prices_a_gap_run_at_ge_a_base():
    """reference.py under linear_score: a gap of l bases costs ge * l,
    and a path's score is its matches less that."""
    from benchmark import reference as R
    lin = RA.linear_score(SCORE)
    for n in range(1, 9):
        assert int(R.gap_cost(lin, n)) == 2 * n
    ref = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int8)
    qry = np.array([0, 1, 2, 3, 2, 3, 1], np.int8)
    kinds, r, q = R.columns(R.parse_cigar("4M2D2M1I"))
    # 6 matches at 2, a deletion run of 2 and an insertion of 1 at 2 a base
    assert R.path_score(lin, kinds, ref, qry, r, q) == 6 * 2 - 3 * 2
    with pytest.raises(ValueError):
        RA.linear_score(dict(SCORE, gi=4))


def test_project_puts_an_intersection_on_its_partner():
    """reference_ava.project: the ends of each true intersection land
    within a few bases of the partner's ends of it, and a point 200 bases
    into it lands about 200 bases into the partner's."""
    pool = gen.Pool.make(SEED, gen.genome(SEED, GENOME), READS, 3450)
    maps: dict = {}
    n = 0
    for i in range(len(pool)):
        for o in RA.true_overlaps(pool, i, maps):
            if o["qe"] - o["qs"] < 400:
                continue
            j, s = o["j"], o["strand"]
            assert abs(RA.project(pool, i, j, s, o["qs"], maps)
                       - o["ts"]) <= 8
            assert abs(RA.project(pool, i, j, s, o["qe"], maps)
                       - o["te"]) <= 8
            mid = RA.project(pool, i, j, s, o["qs"] + 200, maps) - o["ts"]
            assert 170 <= mid <= 230
            n += 1
    assert n >= 4
