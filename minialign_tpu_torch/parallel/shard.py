"""Multi-device sharding for the mapping pipeline.

Carried from the JAX package's minialign_tpu/parallel/shard.py (see its
docstring for the design and SURVEY.md section 2.6) onto PyTorch
devices. A mesh is a list of torch.devices, one a shard; it may name a
device more than once, which is how one GPU runs two shards and how the
CPU tests stand in for the JAX tests' virtual 8-device mesh:

  * data parallelism: extension-problem batches split into contiguous
    blocks over the mesh, one FillEngine a mesh entry, each block on its
    own thread and CUDA stream; no collectives on the hot path.
  * index sharding: the minimizer key table split by sorted hash range;
    query hashes are replicated, each shard answers the lookups falling
    into its range (the D3 kernel, cuda_lookup.lookup), and the shards'
    hits are merged by a sum on the first device (the JAX psum).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..dp import band
from ..params import ScoreParams
from .cuda_lookup import lookup


def make_mesh(n_devices: int | None = None,
              device: str = "cuda") -> list[torch.device]:
    """The visible CUDA devices (the first n_devices of them), or
    n_devices times the CPU (once without n_devices)."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[:n_devices] if n_devices else devs


def _blocks(n: int, n_shards: int) -> list[slice]:
    """n items in contiguous blocks over n_shards, as P("dp") splits an
    axis: ceil(n / n_shards) an entry, the last ones short or empty."""
    per = -(-n // n_shards) if n else 0
    return [slice(min(k * per, n), min((k + 1) * per, n))
            for k in range(n_shards)]


def _groups(mesh) -> list[tuple[torch.device, list[int]]]:
    """The mesh entries of each distinct device, in order of first
    appearance."""
    out: dict[torch.device, list[int]] = {}
    for k, d in enumerate(mesh):
        out.setdefault(torch.device(d), []).append(k)
    return list(out.items())


# ---------------------------------------------------------------------------
# data-parallel band fill
# ---------------------------------------------------------------------------

def make_sharded_fill(p: ScoreParams, W: int, max_blocks: int, mesh,
                      trace: bool = False):
    """Batched fill with the problem axis split over the mesh: each
    entry fills its contiguous block of problems on its device, and the
    results come back concatenated in problem order on the first
    device."""

    def sharded(a, alen, b, blen):
        a, alen, b, blen = (torch.as_tensor(x) for x in (a, alen, b, blen))
        outs = []
        for d, sl in zip(mesh, _blocks(a.shape[0], len(mesh))):
            if sl.start == sl.stop and outs:
                continue
            outs.append(band.fill(p, W, max_blocks, trace,
                                  *(x[sl].to(d) for x in (a, alen, b, blen))))
        head = torch.device(mesh[0])
        res = [o[0] if trace else o for o in outs]
        cat = band.FillResult(
            *(torch.cat([getattr(r, f).to(head) for r in res])
              for f in ("max_score", "max_i", "max_j", "n_steps")),
            n_blocks=torch.stack([r.n_blocks.to(head) for r in res]).max())
        if not trace:
            return cat
        return cat, band.TraceBuffers(*(
            torch.cat([getattr(o[1], f).to(head) for o in outs])
            for f in band.TraceBuffers._fields))

    return sharded


# ---------------------------------------------------------------------------
# sharded index lookup
# ---------------------------------------------------------------------------

def shard_index_arrays(keys: np.ndarray, offsets: np.ndarray,
                       n_shards: int):
    """Split the sorted key table into n_shards contiguous hash ranges,
    padded to a common size. Returns (keys_sh, starts_sh, counts_sh)
    stacked as (n_shards, K_pad) arrays."""
    K = len(keys)
    # bucket-major indexes (round 3) are only per-bucket sorted; the
    # shard tables need global order for the per-shard searchsorted,
    # so sort once at shard build (starts/counts ride along)
    kord = np.argsort(keys, kind="stable")
    keys = np.asarray(keys, np.uint64)[kord]
    st_all = np.asarray(offsets[:-1], np.int64)[kord]
    cn_all = (np.asarray(offsets[1:], np.int64)
              - np.asarray(offsets[:-1], np.int64))[kord]
    per = -(-K // n_shards) if K else 1
    kpad = per * n_shards
    keys_p = np.full(kpad, np.iinfo(np.uint64).max, np.uint64)
    keys_p[:K] = keys
    starts = np.zeros(kpad, np.int64)
    counts = np.zeros(kpad, np.int64)
    starts[:K] = st_all
    counts[:K] = cn_all
    return (keys_p.reshape(n_shards, per),
            starts.reshape(n_shards, per),
            counts.reshape(n_shards, per))


def place_shards(mesh, keys_sh, starts_sh, counts_sh):
    """shard_index_arrays' tables on the mesh: for each distinct device
    (_groups order), one (n_d, K_pad) int64 tensor of the keys (their
    uint64 bits), the starts and the counts of the shards it holds, so
    that the shards sharing a device share one launch."""
    keys_sh = np.ascontiguousarray(keys_sh, np.uint64).view(np.int64)
    out = []
    for d, ks in _groups(mesh):
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.int64)[ks])).to(d)
            for x in (keys_sh, starts_sh, counts_sh)))
    return out


def sharded_lookup(mesh, tables, q):
    """Query hashes (replicated) against place_shards' tables: each
    device's shards in one D3 launch (cuda_lookup.lookup), their hits
    merged by a sum on the first device (each hash lives in exactly one
    shard: the JAX psum). Returns (start, count), (Q,) int64 tensors on
    the first device."""
    groups = _groups(mesh)
    qh = torch.from_numpy(np.ascontiguousarray(q, np.uint64).view(np.int64))
    st = cn = None
    for (d, _), (keys, starts, counts) in zip(groups, tables):
        s, c = lookup(keys, starts, counts, qh.to(d))
        s, c = s.sum(0).to(groups[0][0]), c.sum(0).to(groups[0][0])
        st, cn = (s, c) if st is None else (st + s, cn + c)
    return st, cn


def make_sharded_lookup(mesh):
    """The JAX package's contract: fn(keys_sh, starts_sh, counts_sh, q)
    on shard_index_arrays' tables, placed on the mesh at each call."""
    return lambda keys_sh, starts_sh, counts_sh, q: sharded_lookup(
        mesh, place_shards(mesh, keys_sh, starts_sh, counts_sh), q)


# ---------------------------------------------------------------------------
# the sharded engine, index and pipeline
# ---------------------------------------------------------------------------

class ShardedFillEngine:
    """FillEngine-compatible executor whose requests are split over the
    mesh: one inner FillEngine a mesh entry, each `run` giving entry k
    the k-th contiguous block of the requests on its own thread (and,
    on CUDA, its own stream, so the shards' launches do not wait on one
    another), the results in request order. It has no `use_pallas`, so
    pipeline.align_batch sends it raw code arrays and no duo requests,
    as it does the JAX package's sharded engine. Results are
    bit-identical to the single-device engine (tests/test_torch_shard.py)."""

    def __init__(self, score: ScoreParams, mesh,
                 batch: int | None = None):
        from ..extend import FillEngine

        self.mesh = [torch.device(d) for d in mesh]
        ndev = len(self.mesh)
        per = -(-(batch or 16 * ndev) // ndev)
        self._inner = [FillEngine(score, batch=per, device=d)
                       for d in self.mesh]
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in self.mesh]
        self._pool = ThreadPoolExecutor(ndev)

    @property
    def p(self):
        return self._inner[0].p

    def set_index(self, mi):
        for eng in self._inner:
            eng.set_index(mi)

    def set_queries(self, reads):
        for eng in self._inner:
            eng.set_queries(reads)

    def _run_on(self, k: int, reqs: list) -> list:
        s = self._streams[k]
        if s is None:
            return self._inner[k].run(reqs)
        with torch.cuda.stream(s):
            return self._inner[k].run(reqs)

    def run(self, reqs: list) -> list:
        blocks = [(k, reqs[sl]) for k, sl in
                  enumerate(_blocks(len(reqs), len(self.mesh)))
                  if sl.start < sl.stop]
        # the shards' streams start behind what the caller's stream has
        # queued (the stores set_index and set_queries uploaded)
        for k, _ in blocks:
            if self._streams[k] is not None:
                self._streams[k].wait_stream(
                    torch.cuda.current_stream(self.mesh[k]))
        futs = [self._pool.submit(self._run_on, k, blk) for k, blk in blocks]
        return [r for f in futs for r in f.result()]


class ShardedIndex:
    """MMIndex facade whose minimizer lookups run on the mesh against a
    hash-range-sharded key table with the cross-shard sum as merge (the
    BASELINE config-5 layout: per-host index shards, query hashes
    replicated, hits merged over the mesh). Sequence data and metadata
    stay replicated; only the (keys, offsets) table is sharded."""

    def __init__(self, mi, mesh):
        self._mi = mi
        self.mesh = mesh
        keys_sh, starts_sh, counts_sh = shard_index_arrays(
            mi.keys, mi.offsets, len(mesh))
        self._tables = place_shards(mesh, keys_sh, starts_sh, counts_sh)

    def __getattr__(self, name):
        return getattr(self._mi, name)

    def lookup(self, h):
        h = np.asarray(h, np.uint64)
        if len(h) == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int64))
        st, cn = sharded_lookup(self.mesh, self._tables, h)
        return st.cpu().numpy(), cn.cpu().numpy()


def align_batch_sharded(mp, mi, reads, mesh, base_qid: int = 0,
                        tbuf: dict | None = None):
    """pipeline.align_batch with both parallel axes on the mesh:
    extension problems data-parallel and index lookups against the
    hash-range-sharded table. Output order and content match the
    single-device pipeline exactly."""
    from ..pipeline import align_batch

    smi = ShardedIndex(mi, mesh)
    engine = ShardedFillEngine(mp.score, mesh)
    return align_batch(mp, smi, reads, engine, base_qid=base_qid,
                       tbuf=tbuf)
