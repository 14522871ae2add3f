"""Read-to-reference mapping: the CLI's single-process loop (the -t1
branch of cli._map_block), SAM out.

Inputs: the configuration's genome as FASTA and a read pool as FASTQ,
made from the seed. Index: the genome, built by the CLI's path
(cli.parse_argv / finalize / make_params, then cli._iter_index_blocks,
which calls index.build.build_index). Engine: extend.FillEngine on one
card. Window: io.bseq.read_batches on the FASTQ at the CLI's batch size,
pipeline.align_batch on the engine, io.sam.SamWriter into the frame's
sink. Judge (judge.py): the SAM records of a sample of the window's
reads, and the program's index, against the plain reference.
"""

from __future__ import annotations

import os
import threading
import time

from benchmark import gen, judge, window

CHECKS = judge.CHECKS


class NullSink:
    def write(self, s: str) -> None:
        pass


class EngineProxy:
    """Stands in for the engine in a traced run: times each engine.run and
    counts the moves that the walk made; everything else is the engine's
    (align_batch takes its engine as an argument)."""

    def __init__(self, engine, spans, counters: dict):
        self._e = engine
        self._spans = spans
        self._c = counters
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._e, name)

    def run(self, reqs):
        t0 = time.perf_counter_ns()
        out = self._e.run(reqs)
        t1 = time.perf_counter_ns()
        moves = probs = 0
        for req, o in zip(reqs, out):
            s, i, j = (o[3], o[4], o[5]) if req[0] == "duo" else o[:3]
            if req[0] != "down" and s > 0:
                moves += i + j
                probs += 1
        with self._lock:
            self._spans.add("engine.run", t0, t1)
            self._c["walk_moves"] += moves
            self._c["walk_problems"] += probs
        return out


def _count_fills(extend_mod, held: list):
    """Keeps each fill's per-problem step counts (a traced run only)."""
    orig = extend_mod.fill_store

    def fill_store(p, W, max_blocks, traced, *a, **kw):
        r = orig(p, W, max_blocks, traced, *a, **kw)
        res = r if hasattr(r, "n_steps") else r[0]
        held.append((W, bool(traced), res.n_steps))
        return r
    extend_mod.fill_store = fill_store
    return orig


def _fill_counters(held: list, counters: dict) -> None:
    import torch
    for tr in (False, True):
        key = "traced" if tr else "untraced"
        for W in sorted({w for w, t, _ in held if t == tr}):
            ns = [x for w, t, x in held if t == tr and w == W]
            steps = int(torch.cat([x.reshape(-1).to(torch.int64)
                                   for x in ns]).sum())
            counters[f"fill_steps.{key}"] += steps
            counters[f"fill_cells.{key}"] += W * steps
            counters[f"fill_problems.{key}"] += sum(int(x.numel())
                                                    for x in ns)


class Mode:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str,
                 workdir: str, sample=(48, 8), n_blocks: int = 16):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.workdir = device, workdir
        self.n_sample, self.n_blocks = sample, n_blocks

    def inputs(self) -> None:
        cfg, g = self.cfg, self.cfg["genome"]
        self.genome = gen.genome(self.seed, g["length"])
        self.fasta = os.path.join(self.workdir, "genome.fa")
        self.fastq = os.path.join(self.workdir, "reads.fq")
        with open(self.fasta, "wb") as f:
            f.write(gen.fasta_bytes(g["name"], self.genome))
        self.pool = gen.Pool.make(self.seed, self.genome, cfg["reads"],
                                  int(self.mix["pool_mbases"] * 1e6))
        self.pool.write_fastq(self.fastq)

    def argv(self) -> list:
        return list(self.cfg["preset"]) + [self.fasta, self.fastq]

    def index_files(self) -> list:
        return [self.fasta]

    def prepare(self) -> None:
        from minialign_tpu_torch import (__version__, _build, cli, extend,
                                         native)
        from minialign_tpu_torch.device import resolve_device
        from minialign_tpu_torch.extend import FillEngine
        from minialign_tpu_torch.io import bseq
        from minialign_tpu_torch.io.sam import SamWriter
        from minialign_tpu_torch.params import MM_OMIT_REP
        from minialign_tpu_torch.pipeline import align_batch
        self.cli, self.bseq, self.align_batch = cli, bseq, align_batch
        self._build, self.extend = _build, extend
        self.resolve_device, self.FillEngine = resolve_device, FillEngine
        self.SamWriter = SamWriter

        native.tune_malloc()
        argv = self.argv()
        o = cli.Opts(arg_line="minialign-tpu " + " ".join(argv))
        cli.parse_argv(o, argv)
        cli.finalize(o)
        if o.ecnt:
            raise ValueError(f"preset {self.cfg['preset']} refused")
        if o.batch_size != self.mix["batch_bases"]:
            raise ValueError(f"the CLI's batch is {o.batch_size} bases, the "
                             f"mix says {self.mix['batch_bases']}")
        self.ip, self.mp = cli.make_params(o)
        self.mp.score.check()
        self.o = o
        self.kw = dict(tags=tuple(o.tags), rg_line=o.rg_line,
                       rg_id=o.rg_id, arg_line=o.arg_line,
                       version=__version__,
                       omit_rep=bool(o.flag & MM_OMIT_REP))

    def index(self) -> None:
        self.mi = next(self.cli._iter_index_blocks(
            self.o, self.index_files(), self.ip))

    def engine(self) -> None:
        self.dev = self.resolve_device(self.device)
        self.eng = self.FillEngine(self.mp.score, device=self.dev)

    def make_writer(self, out):
        return self.SamWriter(out, **self.kw)

    def writer(self, sink) -> None:
        self.sink = sink
        self.wr = self.make_writer(sink)
        self.wr.header(self.mi.names, self.mi.lens)

    def batches(self, size):
        o = self.o
        return self.bseq.read_batches(self.fastq, batch_size=size,
                                      keep_qual=o.keep_qual,
                                      min_len=o.min_len,
                                      tags=tuple(o.tag_names))

    def warm_up(self) -> None:
        """The first reads of the pool, not counted."""
        mi = self.mi
        warm = next(self.batches(self.mix["warmup_bases"]))
        wwr = self.make_writer(NullSink())
        for s, reg in zip(warm, self.align_batch(
                self.mp, mi, [s.codes for s in warm], self.eng,
                base_qid=0, tbuf={"rlen": 0})):
            wwr.mapped(mi.names, mi.lens, mi.codes, s, reg)

    def open_window(self, spans, counters: dict, traced: bool):
        self.picks = judge.sample(gen._rng(self.seed, 3), self.pool.length,
                                  *self.n_sample)
        want = set(self.picks)
        self.seen: set = set()
        self.records: dict = {}
        counters.update(dict.fromkeys(
            ["walk_moves", "walk_problems"]
            + [f"fill_{a}.{b}" for a in ("steps", "cells", "problems")
               for b in ("untraced", "traced")], 0))
        self.held: list = []
        self.win_eng = self.eng
        self.orig_fill = None
        if traced:
            self.win_eng = EngineProxy(self.eng, spans, counters)
            self.orig_fill = _count_fills(self.extend, self.held)
        self.launches0 = self._build.LAUNCHES["fill"]
        self.shapes0 = len(self._build.FUSED_SHAPES)
        tb = {"rlen": 0}
        state = {"n_reads": 0}
        pc = time.perf_counter_ns
        mp, mi, wr, sink = self.mp, self.mi, self.wr, self.sink
        records, seen, align_batch = self.records, self.seen, self.align_batch

        def process(item):
            i0, batch = item
            t0 = pc()
            regs = align_batch(mp, mi, [s.codes for s in batch],
                               self.win_eng, base_qid=state["n_reads"],
                               tbuf=tb)
            t1 = pc()
            for s, reg in zip(batch, regs):
                i = int(s.name[1:])
                if i in want and i not in records:
                    sink.cap = []
                    wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
                    records[i] = "".join(sink.cap)
                    sink.cap = None
                else:
                    wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
            t2 = pc()
            if traced:
                spans.add("io.read", i0, t0)
                spans.add("pipeline.align_batch", t0, t1)
                spans.add("io.write", t1, t2)
            state["n_reads"] += len(batch)
            return len(batch), sum(len(s.codes) for s in batch)

        self.src = window.cycle(lambda: self.batches(self.o.batch_size))

        def next_batch():
            t0 = pc()
            b = next(self.src)
            for s in b:
                seen.add(int(s.name[1:]))
            return t0, b

        return iter(next_batch, None), process

    def end_window(self, counters: dict) -> None:
        _build = self._build
        counters["fill_launches"] = _build.LAUNCHES["fill"] - self.launches0
        new = _build.FUSED_SHAPES[self.shapes0:]
        counters["fill_problems"] = sum(s[0] for s in new)
        if self.orig_fill is not None:
            self.extend.fill_store = self.orig_fill
            _fill_counters(self.held, counters)
        self.held.clear()

    def close(self) -> None:
        del self.eng, self.win_eng, self.src

    def judge(self) -> tuple:
        cfg = self.cfg
        return judge.judge(
            cfg["score"], self.genome, cfg["genome"]["name"], self.pool,
            self.picks, self.seen, self.records, gen._rng(self.seed, 4),
            index=self.mi, k=cfg["index"]["k"], w=cfg["index"]["w"],
            n_blocks=self.n_blocks, device=self.device)
