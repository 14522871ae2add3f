"""Alignment pipeline: drives per-read extension generators against the
batched device fill engine, then post-processes into printable regs.

The reference's mtmap pipeline (minialign.c:4535-4732) uses a thread
pool with one read per worker; here a single host thread coordinates
many in-flight reads and the device executes their extension requests
in lockstep batches (see extend.py docstring).

Carried from the JAX package's minialign_tpu/pipeline.py; the imports
differ (the JAX module reaches jax through its extend/band imports), on
the store path a batch's round-0 seeds may come from one device pass
(FillEngine.seed_round0, below) instead of a host call a read, the
stale-rlen pass replays the reads whose guess was wrong together in
lockstep (a read of an all-vs-all batch has tens of extensions to
replay), a read whose chains fall on two or more target sequences runs
them as lanes (extend.plan_lanes: one a target, all in the same engine
rounds) whose results answer its sequential pass and its replays from a
memo kept until the batch's stale-rlen pass ends (_serve), and
align_batch records its spans and counters (stats.py):
`pipeline.extend` around each loop that sends to the extension
generators (their seeding and chaining, and the engine's calls, are
spans of their own inside it), `pipeline.seed` around the batch's seed
pass, `pipeline.post` around the stale-rlen pass and around the
post-processing, `engine.submit` around the upload of the batch's
sequence stores, and the counters `pipeline.reads`,
`pipeline.seed_batched` (reads whose round-0 seeds came from the batch
pass), `pipeline.replays` (reads re-run by the stale-rlen pass),
`pipeline.alns` (the alignments that the post-processing reports,
summed over the batch's reads), `pipeline.lane_reads` (reads run as
lanes), `pipeline.ext_reqs` (the requests that the reads' passes made,
replays included), `pipeline.lane_hits` (of those, the ones answered
from the memo) and `pipeline.lane_unused` (lane results that no pass
read).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import stats
from .extend import Aln, FillEngine, extend_read, seeds_read
from .index.build import MMIndex
from .params import MapParams
from .post import post_map, prune_regs


@dataclasses.dataclass
class RegAln:
    aln: Aln
    mapq: int      # x16 fixed point (printed >> 4)
    aid: int


@dataclasses.dataclass
class Reg:
    """mm_reg_t equivalent."""
    alns: list     # [RegAln], primary first
    n_uniq: int


def _postprocess(mp: MapParams, out) -> Reg | None:
    if out is None:
        return None
    res, slots, _ = out
    if not res:
        return None
    # radix_sort_64x on the offsetted accumulated score
    # (minialign.c:4452): ascending offsetted = descending real, with
    # ksort's exact permutation for equal scores
    from .ksort import ks_radix64
    keys = np.asarray([(0x40000000 - r[0]) & 0xFFFFFFFF for r in res],
                      np.uint32)
    res = [res[i] for i in ks_radix64(keys)]
    res = prune_regs(res, mp.min_ratio)
    n_uniq_bins = post_map(mp, res, slots)

    alns = []
    n_uniq = 0
    for i, (sc, bin_) in enumerate(res):
        for j in bin_.slot_idx:
            alns.append(RegAln(aln=slots[j], mapq=bin_.mapq, aid=i))
        if i == n_uniq_bins - 1:
            n_uniq = len(alns)
    if n_uniq == 0:
        n_uniq = len(alns)
    return Reg(alns=alns, n_uniq=n_uniq)


class _Lanes:
    """A read's lanes (extend.plan_lanes) and what they and its passes
    asked: the memo maps each request, from the read's first lane on, to
    [its result, whether a lane made it, whether a pass read it]. It
    lives until the batch's stale-rlen pass ends, so a replay is answered
    from it too; its results are the engine's own objects, which the
    Alns built from them share."""

    __slots__ = ("todo", "memo", "reqs", "hits")

    def __init__(self):
        self.todo: list = []        # lanes planned and not yet run
        self.memo: dict | None = None
        self.reqs = 0               # requests the passes made
        self.hits = 0               # of those, answered from the memo

    def unused(self) -> int:
        """Lane results that no pass read."""
        return 0 if self.memo is None else sum(
            1 for _, by_lane, read in self.memo.values()
            if by_lane and not read)


def _run_lanes(ln: _Lanes):
    """Runs the lanes in ln.todo to their end, one request a lane an
    engine round, keeping each result in the memo; a request that the
    memo holds already is answered at once."""
    memo = ln.memo = {} if ln.memo is None else ln.memo
    run = [(lane, None) for lane in ln.todo]
    del ln.todo[:]
    while run:
        asked = []
        for lane, out in run:
            try:
                req = lane.send(out)
                while req in memo:
                    req = lane.send(memo[req][0])
            except StopIteration:
                continue
            asked.append((lane, req))
        if not asked:
            return
        outs = yield [req for _, req in asked]
        for (_, req), out in zip(asked, outs):
            memo.setdefault(req, [out, True, False])
        run = [(lane, out) for (lane, _), out in zip(asked, outs)]


def _serve(g, ln: _Lanes):
    """One pass of a read (g, an extend_read generator) as the batch's
    driver takes it: yields the list of requests that the read puts in
    an engine round, receives their results as a list, returns g's value.
    Before each of g's requests, the lanes that g has planned run to their
    end; then a request the memo holds is answered at once, on the host,
    and only the others go to the engine. g decides every request from
    the answers, so the result is its sequential one."""
    try:
        req = next(g)
        while True:
            if ln.todo:
                yield from _run_lanes(ln)
            ln.reqs += 1
            hit = None if ln.memo is None else ln.memo.get(req)
            if hit is not None:
                ln.hits += 1
                hit[2] = True
                out = hit[0]
            else:
                out, = yield [req]
                if ln.memo is not None:
                    ln.memo[req] = [out, False, True]
            req = g.send(out)
    except StopIteration as e:
        return e.value


def align_batch(mp: MapParams, mi: MMIndex, reads: list,
                engine: FillEngine | None = None,
                base_qid: int = 0, tbuf: dict | None = None,
                chain_out: list | None = None) -> list:
    """Map a batch of reads (list of 2-bit code arrays). Returns a Reg
    (or None for unmapped) per read, in input order.

    tbuf ({"rlen": int}) is the reference's thread-buffer state: the
    root bounds test reads the ref length left behind by the previous
    loaded root — across chains, reads, and query files, 0 at the
    start of each index block (one mm_align_init / calloc'd tbuf per
    block, minialign.c:4501+6419). The reference with -t1 therefore
    couples reads SEQUENTIALLY; to keep the batched device pipeline,
    reads run speculatively (first-root test against the current ref
    length) and a post-pass replays the reads whose guess disagrees
    with the true stale value, in lockstep, until none does."""
    engine = engine or FillEngine(mp.score)
    tb = tbuf if tbuf is not None else {"rlen": 0}
    stats.tick()
    if stats.ON:
        stats.add("pipeline.reads", len(reads))
    # device-resident sequence store: avoids per-dispatch sequence
    # uploads by building band inputs with on-device gathers. Default
    # ON for Pallas backends since round 3's DMA-gather kernel
    # (dp/pallas_gather.py) — the XLA take() path that lost in round 2
    # (~8 ns/elem) remains only as the circular-wrap fallback.
    # MINIALIGN_DEVICE_SEQS=0 forces host-built uploads, =1 forces the
    # store even on XLA-fill backends.
    import os
    env = os.environ.get("MINIALIGN_DEVICE_SEQS")
    use_store = hasattr(engine, "set_index") and (
        env == "1" or (env not in ("0", "") and
                       getattr(engine, "use_pallas", False)))
    if use_store:
        sp = stats.begin("engine.submit", base_qid) if stats.ON else None
        engine.set_index(mi)
        engine.set_queries([np.asarray(c, np.int8) for c in reads])
        if sp is not None:
            stats.end(sp)
    duo = (use_store and getattr(engine, "supports_duo", False)
           and os.environ.get("MINIALIGN_DUO", "1") != "0")
    # round-0 seeds of the whole batch in one pass over the query store
    # (FillEngine.seed_round0: the kernel on a card) where the engine
    # takes them that way (FillEngine.seeds_batch: its device and the
    # index); every other read seeds itself in extend_read
    pre = {}
    if use_store and hasattr(engine, "seeds_batch") and \
            engine.seeds_batch(mi):
        sp = stats.begin("pipeline.seed", base_qid, base_qid) \
            if stats.ON else None
        pre = engine.seed_round0(mi, [i for i, c in enumerate(reads)
                                      if seeds_read(mp, mi, len(c))])
        if sp is not None:
            stats.end(sp)
    if stats.ON:
        stats.add("pipeline.seed_batched", len(pre))
    results = {}
    active = {}
    lanes = [_Lanes() for _ in reads]
    sp = stats.begin("pipeline.extend", base_qid) if stats.ON else None
    for i, codes in enumerate(reads):
        # the batch's first read sees a known stale rlen (exact); the
        # rest speculate and are replayed below on a wrong guess
        tbi = {"rlen": tb["rlen"], "spec": i != 0}
        g = extend_read(mp, mi, np.asarray(codes), base_qid + i,
                        qidx=i if use_store else None, tbuf=tbi,
                        duo=duo, seeds0=pre.get(i), lanes=lanes[i].todo)
        if g is None:
            results[i] = None
            continue
        t = _serve(g, lanes[i])
        try:
            active[i] = (t, t.send(None))
        except StopIteration as e:
            results[i] = e.value
    if sp is not None:
        stats.end(sp)

    def drive(act: dict, res: dict) -> None:
        while act:
            sp = stats.begin("pipeline.extend", base_qid) if stats.ON \
                else None
            idxs = list(act.keys())
            reqs = [r for i in idxs for r in act[i][1]]
            outs = engine.run(reqs)
            nxt = {}
            k = 0
            for i in idxs:
                t, asked = act[i]
                try:
                    nxt[i] = (t, t.send(outs[k:k + len(asked)]))
                except StopIteration as e:
                    res[i] = e.value
                k += len(asked)
            act.clear()
            act.update(nxt)
            if sp is not None:
                stats.end(sp)

    # scheduler workers: with >1, each thread drives an interleaved
    # share of the reads through its own dispatch rounds, so one
    # share's host work (seeding/chaining/bookkeeping) overlaps the
    # other's device waits — reads are independent here, and the
    # stale-rlen chain is restored by the replay pass below
    # exactly as for any other execution order. Only the device-store
    # path is multi-worker-safe (the pooled host staging buffers are
    # keyed by shape, not by thread).
    nworkers = 1
    if use_store and len(active) >= 64:
        # default = physical parallelism: on a 1-core host the split
        # only shrinks dispatch batches (A/B: no win); on multi-core
        # hosts each worker's host stage overlaps the others' device
        # waits
        nworkers = max(1, int(os.environ.get(
            "MINIALIGN_SCHED_WORKERS",
            str(min(4, os.cpu_count() or 1)))))
    if nworkers > 1:
        import threading
        shards = [{i: active[i] for i in active if i % nworkers == w}
                  for w in range(nworkers)]
        shard_res = [dict() for _ in range(nworkers)]
        ths = [threading.Thread(target=drive, args=(shards[w],
                                                    shard_res[w]),
                                daemon=True)
               for w in range(1, nworkers)]
        for t in ths:
            t.start()
        drive(shards[0], shard_res[0])
        for t in ths:
            t.join()
        for r in shard_res:
            results.update(r)
    else:
        drive(active, results)

    # stale-rlen pass: walk reads in order and replay each whose
    # speculative first-root bounds test disagrees with the true value.
    # A read depends on the incoming rlen only through that test, so the
    # reads that disagree are replayed together, in lockstep through
    # drive(), each with the rlen that the walk handed it; the walk then
    # runs again, since a replayed read may leave another rlen behind.
    # The first read that disagrees gets its true value each time, so
    # every walk settles at least one more read, and the result is the
    # sequential replay's.
    sp = stats.begin("pipeline.post", base_qid) if stats.ON else None
    replayed = set()
    while True:
        cur = tb["rlen"]
        redo = {}
        for i in range(len(reads)):
            out = results.get(i)
            if out is None:
                continue
            rec = out[2]
            if rec["first"] is not None:
                fa, fb = rec["first"]
                if (fa >= cur or fb >= len(reads[i])) != rec["fired"]:
                    redo[i] = cur
            if rec["out_rlen"] is not None:
                cur = rec["out_rlen"]
        if not redo:
            break
        replayed.update(redo)
        act = {}
        spx = stats.begin("pipeline.extend", base_qid) if stats.ON else None
        for i, rlen in redo.items():
            g = extend_read(mp, mi, np.asarray(reads[i]), base_qid + i,
                            qidx=i if use_store else None,
                            tbuf={"rlen": rlen, "spec": False}, duo=duo,
                            seeds0=pre.get(i))
            t = _serve(g, lanes[i])
            try:
                act[i] = (t, t.send(None))
            except StopIteration as e:
                results[i] = e.value
        if spx is not None:
            stats.end(spx)
        drive(act, results)
    tb["rlen"] = cur
    if chain_out is not None:
        # per-read chain summary for the cross-host replay check
        # (parallel/distributed.merge_host_outputs): enough to
        # re-evaluate the first-root bounds test under the TRUE
        # incoming rlen and to advance the chain without remapping
        for i in range(len(reads)):
            out = results.get(i)
            rec = out[2] if out is not None else None
            chain_out.append(None if rec is None else {
                "first": rec["first"], "fired": rec["fired"],
                "out_rlen": rec["out_rlen"], "qlen": len(reads[i])})
    if sp is not None:
        stats.end(sp)
        stats.add("pipeline.replays", len(replayed))
        stats.add("pipeline.lane_reads",
                  sum(ln.memo is not None for ln in lanes))
        stats.add("pipeline.ext_reqs", sum(ln.reqs for ln in lanes))
        stats.add("pipeline.lane_hits", sum(ln.hits for ln in lanes))
        stats.add("pipeline.lane_unused", sum(ln.unused() for ln in lanes))
    # the memos go with the batch
    del lanes

    sp = stats.begin("pipeline.post", base_qid) if stats.ON else None
    regs = [_postprocess(mp, results.get(i)) for i in range(len(reads))]
    if sp is not None:
        stats.end(sp)
        stats.add("pipeline.alns", sum(len(r.alns) for r in regs
                                       if r is not None))
    return regs
