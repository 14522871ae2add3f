"""Multi-host data-parallel mapping (SURVEY.md §2.6; the reference has
no multi-node anything — its analogue is pt_stream's ordered drain,
minialign.c:4633-4645, lifted to hosts).

Deployment model: every host runs `run_host()` with the same CLI argv;
`initialize()` joins the hosts' torch.distributed process group. Query
batches are assigned round-robin by global batch rank;
each host maps its share and writes (a) `#batch`-sectioned record
payloads and (b) a JSON chain sidecar per batch. Host 0 then calls
`merge_host_outputs()` which restores global batch order AND restores
the reference's -t1 tbuf semantics across hosts: the stale-rlen state
(PARITY.md item 8) chains through ALL batches sequentially, so each
host maps with a speculative incoming rlen and the merger re-walks the
recorded per-read chain under the true value, remapping the rare batch
whose first-root bounds test disagrees (the same speculate+replay
design pipeline.align_batch uses within a batch). The merged file is
byte-identical to the single-process output (tests/test_distributed.py).

Carried from the JAX package's minialign_tpu/parallel/distributed.py;
it differs only in the imports, in `initialize` (torch.distributed with
the gloo backend in place of jax.distributed), in the device of the
engines that `run_host` and `merge_host_outputs` build (the CLI's,
$MINIALIGN_TORCH_DEVICE), and in `merge_setup`, which lets the merge's
own start-up (argv, index, engine, device context) run while the
workers map. The `#batch`, `.chain` and `.stats` files are
the same, so a worker file written by either package merges in the
other (tests/test_torch_distributed.py).
"""

from __future__ import annotations

import io
import json


def initialize(coordinator: str, n_hosts: int, host_id: int) -> None:
    """Join the hosts' torch.distributed process group (gloo, over TCP
    at the coordinator's host:port). Nothing collective runs in
    run_host: the group is the rendezvous of the hosts."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                            world_size=n_hosts, rank=host_id)


def host_batches(batches, host_id: int, n_hosts: int):
    """Deterministic round-robin batch assignment: yields (global
    rank, batch) for the batches this host owns."""
    for rank, batch in enumerate(batches):
        if rank % n_hosts == host_id:
            yield rank, batch


def _plan(o, queries, mi_blocks):
    """Deterministic global batch enumeration shared by hosts and the
    merger: yields (rank, block_idx, base_qid, batch)."""
    from ..io import bseq

    rank = 0
    n_reads = 0  # accumulates across index blocks, mirroring cli.main
    for bi, _mi in enumerate(mi_blocks):
        for path in queries:
            for batch in bseq.read_batches(path,
                                           batch_size=o.batch_size,
                                           keep_qual=o.keep_qual,
                                           min_len=o.min_len,
                                           tags=tuple(o.tag_names)):
                yield rank, bi, n_reads, batch
                rank += 1
                n_reads += len(batch)


def _align_setup(argv):
    """Parse the CLI argv the way cli.main does and build the mapping
    context (opts, params, index blocks, query list, writer factory)."""
    from .. import cli as _cli

    o = _cli.Opts(arg_line="minialign-tpu " + " ".join(argv))
    _cli.parse_argv(o, list(argv))
    _cli.finalize(o)
    if o.ecnt:
        raise ValueError("bad options")
    ip, mp = _cli.make_params(o)
    rt, qh = 1, 1
    if (o.flag & _cli.MM_AVA) and not _cli._is_mai(o.args[0]):
        rt, qh = len(o.args), 0
    queries = o.args[qh:] or ["-"]
    log = _cli.Log(0)
    blocks = list(_cli._iter_index_blocks(o, o.args[:rt], ip))

    def make_writer(out):
        from ..io.sam import (Blast6Writer, MafWriter, PafWriter,
                              SamWriter)
        omit = bool(o.flag & _cli.MM_OMIT_REP)
        if o.fmt == _cli.FMT_SAM:
            return SamWriter(out, tags=tuple(o.tags), rg_line=o.rg_line,
                             rg_id=o.rg_id, arg_line=o.arg_line,
                             version=_cli.__version__, omit_rep=omit)
        if o.fmt == _cli.FMT_MAF:
            return MafWriter(out, tags=tuple(o.tags), omit_rep=omit)
        if o.fmt == _cli.FMT_BLAST6:
            return Blast6Writer(out, tags=tuple(o.tags), omit_rep=omit)
        return PafWriter(out, tags=tuple(o.tags))

    return o, mp, blocks, queries, make_writer, log


def run_host(argv: list, out_path: str, host_id: int, n_hosts: int,
             coordinator: str | None = None) -> None:
    """Map this host's round-robin share of batches. Writes
    `#batch\\t<rank>\\t<rlen_guess>` sections of formatted records to
    out_path and per-batch chain sidecars to out_path + '.chain'."""
    if coordinator is not None:
        initialize(coordinator, n_hosts, host_id)
    from ..device import env_device
    from ..extend import FillEngine
    from ..pipeline import align_batch

    o, mp, blocks, queries, make_writer, _log = _align_setup(argv)
    engine = FillEngine(mp.score, device=env_device())
    wr = make_writer(io.StringIO())

    # MINIALIGN_DIST_WARM=1: map this host's share once untimed first
    # (discarded), so lazy per-shape XLA compiles are out of the timed
    # pass — the scaling benchmark wants steady-state mapping cost
    import os as _os
    if _os.environ.get("MINIALIGN_DIST_WARM"):
        _tbs = {}
        for rank, bi, base_qid, batch in _plan(o, queries, blocks):
            if rank % n_hosts == host_id:
                align_batch(mp, blocks[bi], [s.codes for s in batch],
                            engine, base_qid=base_qid,
                            tbuf=_tbs.setdefault(bi, {"rlen": 0}))

    # mapping-phase busy time (CPU seconds, scheduler-independent):
    # written to out_path + '.stats' so the scaling benchmark can
    # report busy-time efficiency with per-process fixed startup
    # (interpreter, jax init, index load, compiles) excluded
    import time as _time
    _t_cpu0 = _time.process_time()
    _t_wall0 = _time.time()

    with open(out_path, "w") as f, \
            open(out_path + ".chain", "w") as cf:
        # per-host speculative chain over ITS OWN batches of each
        # block (0 at block start, mm_align_init per block)
        tbs = {}
        for rank, bi, base_qid, batch in _plan(o, queries, blocks):
            if rank % n_hosts == host_id:
                mi = blocks[bi]
                tb = tbs.setdefault(bi, {"rlen": 0})
                guess = tb["rlen"]
                chain = []
                regs = align_batch(mp, mi, [s.codes for s in batch],
                                   engine, base_qid=base_qid, tbuf=tb,
                                   chain_out=chain)
                buf = io.StringIO()
                wr.out = buf
                for s, reg in zip(batch, regs):
                    wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
                f.write(f"#batch\t{rank}\t{guess}\n")
                f.write(buf.getvalue())
                cf.write(json.dumps({"rank": rank, "block": bi,
                                     "rlen_in": guess,
                                     "reads": chain}) + "\n")
    with open(out_path + ".stats", "w") as sf:
        sf.write(json.dumps({
            "busy_map_s": _time.process_time() - _t_cpu0,
            "wall_map_s": _time.time() - _t_wall0}))


def _chain_ok(entries, cur):
    """Re-walk a batch's recorded per-read chain under the true
    incoming rlen (the cross-host analogue of align_batch's replay
    pass). Returns (ok, cur_out)."""
    for e in entries:
        if e is None:
            continue
        if e["first"] is not None:
            fa, fb = e["first"]
            fired = fa >= cur or fb >= e["qlen"]
            if fired != e["fired"]:
                return False, cur
        if e["out_rlen"] is not None:
            cur = e["out_rlen"]
    return True, cur


def merge_setup(argv: list):
    """What merge_host_outputs needs before it reads a host file: the
    mapping context (_align_setup) and the engine that remaps, its
    device context opened. cli._align_procs builds it while its workers
    map, so that the merge's start-up does not follow theirs."""
    import torch

    from ..device import env_device
    from ..extend import FillEngine

    setup = _align_setup(argv)
    engine = FillEngine(setup[1].score, device=env_device())
    torch.zeros(1, device=engine.device)
    return setup, engine


def merge_host_outputs(argv: list, host_paths: list, out,
                       setup=None) -> int:
    """Merge per-host outputs into the byte-exact single-process
    stream: headers per index block, batches in global rank order,
    with any batch whose speculative incoming rlen proved wrong
    remapped here under the true chain value. Returns #remapped.
    `setup` is merge_setup(argv)'s result, built here when not given."""
    from ..device import env_device
    from ..extend import FillEngine
    from ..pipeline import align_batch

    if setup is None:
        setup = _align_setup(argv), None
    (o, mp, blocks, queries, make_writer, _log), engine = setup

    payloads, guesses, chains = {}, {}, {}
    for path in host_paths:
        with open(path) as f:
            rank = None
            buf = []
            for line in f:
                if line.startswith("#batch\t"):
                    if rank is not None:
                        payloads[rank] = "".join(buf)
                    _, r, g = line.rstrip("\n").split("\t")
                    rank, buf = int(r), []
                    guesses[rank] = int(g)
                else:
                    buf.append(line)
            if rank is not None:
                payloads[rank] = "".join(buf)
        with open(path + ".chain") as cf:
            for line in cf:
                d = json.loads(line)
                chains[d["rank"]] = d

    wr = make_writer(out)
    n_remap = 0
    cur_block = -1
    cur = 0
    for rank, bi, base_qid, batch in _plan(o, queries, blocks):
        mi = blocks[bi]
        if bi != cur_block:
            wr.header(mi.names, mi.lens)
            cur_block, cur = bi, 0
        # a differing guess is harmless unless some read's first-root
        # bounds test flips under the true chain (rlen reaches output
        # only through those decisions — the same invariant
        # align_batch's in-batch replay relies on)
        ok, cur_out = _chain_ok(chains[rank]["reads"], cur)
        if ok:
            out.write(payloads[rank])
            cur = cur_out
            continue
        # speculation failed: remap this batch under the true chain
        n_remap += 1
        if engine is None:
            engine = FillEngine(mp.score, device=env_device())
        tb = {"rlen": cur}
        regs = align_batch(mp, mi, [s.codes for s in batch], engine,
                           base_qid=base_qid, tbuf=tb)
        for s, reg in zip(batch, regs):
            wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
        cur = tb["rlen"]
    return n_remap
