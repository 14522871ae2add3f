"""Alignment pipeline: drives per-read extension generators against the
batched device fill engine, then post-processes into printable regs.

The reference's mtmap pipeline (minialign.c:4535-4732) uses a thread
pool with one read per worker; here a single host thread coordinates
many in-flight reads and the device executes their extension requests
in lockstep batches (see extend.py docstring).

Carried from the JAX package's minialign_tpu/pipeline.py unchanged; only
the imports differ (the JAX module reaches jax through its extend/band
imports).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .extend import Aln, FillEngine, extend_read
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


def _pump_single(engine, g):
    """Drive one extension generator to completion (used for stale-rlen
    replays; see align_batch)."""
    try:
        req = g.send(None)
        while True:
            out = engine.run([req])[0]
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
    length) and a sequential post-pass replays the rare read whose
    guess disagrees with the true stale value."""
    engine = engine or FillEngine(mp.score)
    tb = tbuf if tbuf is not None else {"rlen": 0}
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
        engine.set_index(mi)
        engine.set_queries([np.asarray(c, np.int8) for c in reads])
    duo = (use_store and getattr(engine, "supports_duo", False)
           and os.environ.get("MINIALIGN_DUO", "1") != "0")
    results = {}
    active = {}
    for i, codes in enumerate(reads):
        # the batch's first read sees a known stale rlen (exact); the
        # rest speculate and are replayed below on a wrong guess
        tbi = {"rlen": tb["rlen"], "spec": i != 0}
        g = extend_read(mp, mi, np.asarray(codes), base_qid + i,
                        qidx=i if use_store else None, tbuf=tbi,
                        duo=duo)
        if g is None:
            results[i] = None
            continue
        try:
            req = g.send(None)
            active[i] = (g, req)
        except StopIteration as e:
            results[i] = e.value

    def drive(act: dict, res: dict) -> None:
        while act:
            idxs = list(act.keys())
            reqs = [act[i][1] for i in idxs]
            outs = engine.run(reqs)
            nxt = {}
            for i, out in zip(idxs, outs):
                g = act[i][0]
                try:
                    req = g.send(out)
                    nxt[i] = (g, req)
                except StopIteration as e:
                    res[i] = e.value
            act.clear()
            act.update(nxt)

    # scheduler workers: with >1, each thread drives an interleaved
    # share of the reads through its own dispatch rounds, so one
    # share's host work (seeding/chaining/bookkeeping) overlaps the
    # other's device waits — reads are independent here, and the
    # stale-rlen chain is restored by the sequential replay pass below
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

    # sequential stale-rlen pass: walk reads in order, replay any whose
    # speculative first-root bounds test disagrees with the true value
    cur = tb["rlen"]
    for i in range(len(reads)):
        out = results.get(i)
        if out is None:
            if chain_out is not None:
                chain_out.append(None)
            continue
        rec = out[2]
        if rec["first"] is not None:
            fa, fb = rec["first"]
            fired = fa >= cur or fb >= len(reads[i])
            if fired != rec["fired"]:
                g = extend_read(mp, mi, np.asarray(reads[i]),
                                base_qid + i,
                                qidx=i if use_store else None,
                                tbuf={"rlen": cur, "spec": False},
                                duo=duo)
                out = _pump_single(engine, g)
                results[i] = out
                rec = out[2] if out is not None else None
        if rec is not None and rec["out_rlen"] is not None:
            cur = rec["out_rlen"]
        if chain_out is not None:
            # per-read chain summary for the cross-host replay check
            # (parallel/distributed.merge_host_outputs): enough to
            # re-evaluate the first-root bounds test under the TRUE
            # incoming rlen and to advance the chain without remapping
            chain_out.append(None if rec is None else {
                "first": rec["first"], "fired": rec["fired"],
                "out_rlen": rec["out_rlen"], "qlen": len(reads[i])})
    tb["rlen"] = cur

    return [_postprocess(mp, results.get(i)) for i in range(len(reads))]
