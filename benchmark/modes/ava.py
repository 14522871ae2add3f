"""All-vs-all overlap of a read set, PAF out: the CLI's `-X -xava` run on
one FASTQ that is both the index and the queries (cli.main's `rt, qh`
split for -X without a prebuilt index), through its single-process loop
(the -t1 branch of cli._map_block).

Inputs: the configuration's whole read set (coverage x genome length),
made from the seed, as one FASTQ. Index: that file, built by the CLI's
path (cli._iter_index_blocks). Engine: extend.FillEngine on one card.
Window: the map mode's (modes/map.py), io.sam.PafWriter into the
frame's sink; for the sampled reads the PAF text is kept, and from the
Reg that it was printed from the paths of the read's 4 longest non-self
alignments, so that the judge holds the timed path's own alignment paths
(PAF prints none). The sample is drawn from the reads of the set's first
4 Mb, which every window reads (the map mode's draw over the whole set
would find only the few sampled reads that a window of ~10 Mb reaches).

Judge, over the sampled reads that the window read, against the plain
reference (reference_ava.py), each number against the cell's limit:

- missing: reads with no PAF line as the query.
- malformed: lines with fewer than 12 fields, a query or target name or
  length other than the pool's, coordinates outside [0, len] or start
  >= end, a strand other than + or -, mcnt > blk; and judged paths whose
  target, strand or spans are not those of the line printed from the same
  alignment, or whose CIGAR does not span them.
- self_short: reads whose line to themselves is missing or does not span
  the whole read on both sides, on '+'.
- false_overlap: lines to another read that lie on no true overlap: the
  two reads' origins do not intersect, the strand is not the relative
  strand, or the line's ends are off the true alignment of the two reads
  (reference_ava.project) by more than DIAG_SLACK bases, as a line put
  at the wrong coordinates is. The preset prints lines between unrelated
  reads of its own, as the JAX package does on the same reads: under its
  scores (+2/-3, a gap 2 a base) an alignment of unrelated random
  sequence gains a little a column, so X-drop does not stop it, and the
  bonus that the reference adds to a root's score for the query span it
  covers (minialign.c:4018-4067, extend.extend_read) lets a long one pass
  -m0.05. So the limit is a count from the program's readings and a
  fault's, as for missed_overlap, and such a line fails no read.
- missed_overlap: true overlaps of >= 5 kb between the read and another
  read, both of accuracy >= 0.85, that the read printed no line on.
- seg_gap: the widest shortfall, in score points, of the program's path
  against the best path between the same two of its points under the
  linear model, over up to 4 segments of 1,024 query bases on each of
  the true ones among the read's 4 longest non-self alignments
  (judge.py's segments and band, reference.band_dp in int32). A false
  line's path aligns unrelated sequence, whose best path between two
  points wanders far from the line between them.
- index_diff: (hash, pos, strand) entries in which the program's index
  and reference_ava.sketch differ, over sampled reads of the set.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from benchmark import gen, judge as map_judge, reference as R
from benchmark import reference_ava as RA
from benchmark.modes import map as map_mode

CHECKS = ("missing", "malformed", "self_short", "false_overlap",
          "missed_overlap", "seg_gap", "index_diff")
MISSED_MIN_BASES = 5000
MISSED_MIN_ACC = 0.85
PATHS_PER_READ = 4
DIAG_SLACK = 64
SAMPLE_PREFIX_BASES = 4_000_000


def read_set_bases(cfg: dict) -> int:
    """The configuration's whole read set: coverage x genome length."""
    return int(cfg["coverage"] * cfg["genome"]["length"])


def prefix_reads(pool) -> int:
    """How many reads from the set's start hold SAMPLE_PREFIX_BASES
    bases (at least one): the reads the sample is drawn from."""
    return max(1, int(np.searchsorted(np.cumsum(pool.length),
                                      SAMPLE_PREFIX_BASES)))


def path_records(i: int, reg, seg_cigar) -> list:
    """The path records (`judge`) of read i's PATHS_PER_READ longest
    non-self alignments (by query span) in a Reg, each with the number of
    the PAF line printed from its alignment (PafWriter prints one line an
    alignment, in the Reg's order)."""
    alns = [(k, ra.aln) for k, ra in
            enumerate(reg.alns if reg is not None else [])
            if ra.aln.rid != i]
    alns.sort(key=lambda x: x[1].be - x[1].bs0, reverse=True)
    return [{"line": k, "j": int(a.rid), "strand": "-" if a.rev else "+",
             "ts": int(s.as0), "te": int(s.ae), "qs": int(s.bs0),
             "qe": int(s.be), "cigar": seg_cigar(a, s)}
            for k, a in alns[:PATHS_PER_READ] for s in a.segs]


class _Keeper:
    """The window's writer: the mode's PafWriter, and the path records
    of each read whose PAF text the frame's sink captures (the sampled
    reads)."""

    def __init__(self, wr, sink, paths: dict, seg_cigar):
        self.wr, self.sink, self.paths = wr, sink, paths
        self.seg_cigar = seg_cigar

    def header(self, names, lens):
        self.wr.header(names, lens)

    def mapped(self, ref_names, ref_lens, ref_codes, seq, reg):
        if self.sink.cap is not None:
            i = int(seq.name[1:])
            self.paths[i] = path_records(i, reg, self.seg_cigar)
        self.wr.mapped(ref_names, ref_lens, ref_codes, seq, reg)


class Mode(map_mode.Mode):
    def inputs(self) -> None:
        self.genome = gen.genome(self.seed, self.cfg["genome"]["length"])
        self.fastq = os.path.join(self.workdir, "reads.fq")
        self.pool = gen.Pool.make(self.seed, self.genome, self.cfg["reads"],
                                  read_set_bases(self.cfg))
        self.pool.write_fastq(self.fastq)

    def argv(self) -> list:
        return list(self.cfg["preset"]) + [
            "-1", str(self.mix["batch_bases"]), self.fastq]

    def index_files(self) -> list:
        return [self.fastq]

    def prepare(self) -> None:
        super().prepare()
        from minialign_tpu_torch.io.sam import PafWriter, seg_cigar
        from minialign_tpu_torch.params import LINEAR
        self.PafWriter, self.seg_cigar = PafWriter, seg_cigar
        sc, want = self.mp.score, self.cfg["score"]
        got = {"matrix": list(sc.matrix), "gi": sc.gi, "ge": sc.ge,
               "gfa": sc.gfa, "gfb": sc.gfb,
               "model": "LINEAR" if sc.model == LINEAR else sc.model}
        if got != want:
            raise ValueError(f"the CLI's scores {got} are not the "
                             f"configuration's {want}")

    def make_writer(self, out):
        return self.PafWriter(out, tags=tuple(self.o.tags))

    def writer(self, sink) -> None:
        super().writer(sink)
        self.paths: dict = {}
        self.wr = _Keeper(self.wr, sink, self.paths, self.seg_cigar)

    def open_window(self, spans, counters: dict, traced: bool):
        """The map mode's window, its sample drawn from the reads of the
        set's first SAMPLE_PREFIX_BASES bases."""
        pool = self.pool
        self.pool = dataclasses.replace(
            pool, length=pool.length[:prefix_reads(pool)])
        try:
            return super().open_window(spans, counters, traced)
        finally:
            self.pool = pool

    def judge(self) -> tuple:
        cfg = self.cfg
        notes: dict = {}
        out = judge(cfg["score"], self.pool, self.picks, self.seen,
                    self.records, self.paths, gen._rng(self.seed, 4),
                    index=self.mi, k=cfg["index"]["k"], w=cfg["index"]["w"],
                    n_reads=self.n_blocks, device=self.device, notes=notes)
        print(f"[bench] ava judge: false lines by cause "
              f"{notes['false_by_cause']}; a true line's ends at most "
              f"{notes['true_line_end_off_max']} bases off the true "
              f"alignment", file=sys.stderr)
        return out


def _parse(line: str, i: int, qlen: int, lens: dict):
    """(target, strand, qs, qe, ts, te) of a PAF line of read i, or None
    where the line is malformed; lens(j) gives read j's length."""
    f = line.split("\t")
    if len(f) < 12 or f[0] != f"r{i}" or f[1] != str(qlen):
        return None
    t = f[5]
    if not (t.startswith("r") and t[1:].isdigit()):
        return None
    j = int(t[1:])
    if j >= lens["n"] or f[6] != str(lens[j]) or f[4] not in ("+", "-"):
        return None
    try:
        qs, qe, ts, te, mcnt, blk = (int(f[k]) for k in (2, 3, 7, 8, 9, 10))
    except ValueError:
        return None
    if not (0 <= qs < qe <= qlen and 0 <= ts < te <= lens[j]) \
            or mcnt > blk:
        return None
    return j, f[4], qs, qe, ts, te


class _Lens(dict):
    """Read lengths from the reference's read maps, made on first use."""

    def __init__(self, pool, maps: dict):
        super().__init__(n=len(pool))
        self.pool, self.maps = pool, maps

    def __missing__(self, j):
        if j not in self.maps:
            self.maps[j] = RA.read_map(self.pool, j)
        self[j] = int(self.maps[j][-1])
        return self[j]


def off_diagonal(pool, i: int, o: dict, p: tuple, maps: dict):
    """How far, in target bases, the ends of read i's line p = (j, strand,
    qs, qe, ts, te) lie from where the true alignment of the pair (o, a
    `reference_ava.true_overlaps` entry) puts them; None where the line's
    spans miss the pair's true intersection."""
    j, strand, qs, qe, ts, te = p
    if qe <= o["qs"] or o["qe"] <= qs or te <= o["ts"] or o["te"] <= ts:
        return None
    return max(abs(RA.project(pool, i, j, strand, qs, maps) - ts),
               abs(RA.project(pool, i, j, strand, qe, maps) - te))


def judge(score: dict, pool, picks: list, seen: set, records: dict,
          paths: dict, rng: np.random.Generator, index=None, k: int = 15,
          w: int = 5, n_reads: int = 16, device="cpu",
          notes: dict | None = None) -> tuple:
    """({check: value}, reads judged, reads failed). `records` maps pool
    index -> the PAF text printed for it; `paths` maps it to path records
    ({"line", "j", "strand", "ts", "te", "qs", "qe", "cigar"}: the number
    of the read's line printed from the alignment, target, strand, the
    path's target and strand-space query spans, its CIGAR) of its
    non-self alignments; `seen` holds the pool indices that the window
    read; `index` is the program's MMIndex (None: not judged). `notes`,
    where given, gets the false lines split by cause and the largest
    distance of a true line's ends from the true alignment."""
    v = dict.fromkeys(CHECKS, 0)
    why = {"read": 0, "strand": 0, "diagonal": 0}
    worst = 0
    lin = RA.linear_score(score)
    maps: dict = {}
    lens = _Lens(pool, maps)
    judged = failed = 0
    refs, qrys, scores = [], [], []
    for i in picks:
        if i not in seen:
            continue
        judged += 1
        text = records.get(i, "")
        if not text:
            v["missing"] += 1
            failed += 1
            continue
        bad = 0
        qlen = lens[i]
        true = {o["j"]: o for o in RA.true_overlaps(pool, i, maps)}
        parsed, on_true = [], set()
        printed, self_ok = set(), False
        for n, line in enumerate(text.splitlines()):
            p = _parse(line, i, qlen, lens)
            parsed.append(p)
            if p is None:
                v["malformed"] += 1
                bad += 1
                continue
            j, strand = p[0], p[1]
            if j == i:
                self_ok |= p[1:] == ("+", 0, qlen, 0, qlen)
                continue
            o = true.get(j)
            d = None if o is None or o["strand"] != strand else \
                off_diagonal(pool, i, o, p, maps)
            if d is None or d > DIAG_SLACK:
                v["false_overlap"] += 1
                why["read" if o is None else "strand"
                    if o["strand"] != strand else "diagonal"] += 1
                continue
            worst = max(worst, d)
            printed.add(j)
            on_true.add(n)
        if not self_ok:
            v["self_short"] += 1
            bad += 1
        if pool.acc[i] >= MISSED_MIN_ACC:
            v["missed_overlap"] += sum(
                1 for j, o in true.items()
                if o["glen"] >= MISSED_MIN_BASES and j not in printed
                and pool.acc[j] >= MISSED_MIN_ACC)
        qcodes = None
        longest = sorted(paths.get(i, []),
                         key=lambda x: x["qe"] - x["qs"], reverse=True)
        for pr in longest[:PATHS_PER_READ]:
            n = pr["line"]
            if not 0 <= n < len(parsed) or parsed[n] != tuple(
                    pr[x] for x in ("j", "strand", "qs", "qe", "ts", "te")):
                v["malformed"] += 1     # not the line printed from it
                bad += 1
                continue
            if n not in on_true:
                continue            # a false line's path: a random walk
            try:
                ops = R.parse_cigar(pr["cigar"])
            except ValueError:
                v["malformed"] += 1
                bad += 1
                continue
            kinds, r, q = R.columns(ops)
            if (int(r[-1]), int(q[-1])) != (pr["te"] - pr["ts"],
                                            pr["qe"] - pr["qs"]):
                v["malformed"] += 1
                bad += 1
                continue
            if qcodes is None:
                qcodes = pool.codes(i)
            qo = RA.strand_seq(qcodes, pr["strand"])[pr["qs"]:]
            ro = pool.codes(pr["j"])[pr["ts"]:]
            for c0, c1 in map_judge._segments(rng, kinds, r, q):
                rs, re_, qs, qe = r[c0], r[c1], q[c0], q[c1]
                refs.append(ro[rs:re_])
                qrys.append(qo[qs:qe])
                rr, qq = r[c0:c1 + 1] - rs, q[c0:c1 + 1] - qs
                scores.append((R.path_score(lin, kinds[c0:c1], refs[-1],
                                            qrys[-1], rr, qq),
                               map_judge._deviation(rr, qq)))
        failed += bad > 0
    if refs:
        half = min(1024, -(-(max(d for _, d in scores) + 16) // 16) * 16)
        half = max(half, 32)
        opt, _ = R.band_dp(lin, refs, qrys, half, device=device)
        v["seg_gap"] = int(max(int(o) - s for o, (s, _) in zip(opt, scores)))
    if index is not None:
        v["index_diff"] = index_diff(pool, index, rng, k, w, n_reads)
    else:
        del v["index_diff"]
    if notes is not None:
        notes.update(false_by_cause=why, true_line_end_off_max=worst)
    return v, judged, failed


def index_diff(pool, mi, rng: np.random.Generator, k: int, w: int,
               n_reads: int) -> int:
    """Entries in which the index's minimizers of n_reads sampled reads
    (index sequence j is read j) and the reference sketch differ."""
    picks = np.sort(rng.choice(len(pool), min(n_reads, len(pool)),
                               replace=False))
    vr = np.asarray(mi.vals_rid)
    sel = np.flatnonzero(np.isin(vr >> 1, picks))
    off = np.asarray(mi.offsets, np.int64)
    kidx = np.searchsorted(off, sel, side="right") - 1
    prog = set(zip((vr[sel] >> 1).tolist(),
                   np.asarray(mi.keys)[kidx].tolist(),
                   np.asarray(mi.vals_pos)[sel].tolist(),
                   (vr[sel] & 1).tolist()))
    ref = set()
    for j in picks.tolist():
        ref |= {(j,) + e for e in RA.sketch(pool.codes(j), k, w)}
    return len(prog ^ ref)
