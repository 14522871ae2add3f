"""All-vs-all overlap of the read pool, PAF out: a mode for the tests
only, which shows that such a cell runs through the frame (run.py) as
it stands, with a mode file of its own. It is the map mode with the
pool as the index (`-X -xava` on the one FASTQ, as cli.main runs it),
io.sam.PafWriter into the frame's sink, and its own judge:

- missing: sampled reads that the window read and printed no PAF line
  for as the query.
- no_true_overlap: sampled reads none of whose targets, other than the
  read itself, overlaps the read's true origin on the genome.
"""

from __future__ import annotations

import os

from benchmark import gen
from benchmark.modes import map as map_mode

CHECKS = ("missing", "no_true_overlap")


class Mode(map_mode.Mode):
    def inputs(self) -> None:
        self.genome = gen.genome(self.seed, self.cfg["genome"]["length"])
        self.fastq = os.path.join(self.workdir, "reads.fq")
        self.pool = gen.Pool.make(self.seed, self.genome, self.cfg["reads"],
                                  int(self.mix["pool_mbases"] * 1e6))
        self.pool.write_fastq(self.fastq)

    def argv(self) -> list:
        return ["-X", "-xava", self.fastq]

    def index_files(self) -> list:
        return [self.fastq]

    def make_writer(self, out):
        from minialign_tpu_torch.io.sam import PafWriter
        return PafWriter(out, tags=tuple(self.o.tags))

    def judge(self) -> tuple:
        v = dict.fromkeys(CHECKS, 0)
        st, ln = self.pool.start, self.pool.length
        judged = failed = 0
        for i in self.picks:
            if i not in self.seen:
                continue
            judged += 1
            rows = [x.split("\t") for x in
                    self.records.get(i, "").splitlines()]
            targets = {int(f[5][1:]) for f in rows if f[0] == f"r{i}"}
            if not targets:
                v["missing"] += 1
                failed += 1
            elif not any(st[j] < st[i] + ln[i] and st[i] < st[j] + ln[j]
                         for j in targets - {i}):
                v["no_true_overlap"] += 1
                failed += 1
        return v, judged, failed
