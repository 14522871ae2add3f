"""Times the gather (K2), fill (K1) and walk (K3) kernels at the main
path's shapes, the step-mix probes (P1-P4), and profiles the end-to-end
run, on one CUDA card.

    python minialign_tpu_torch/kbench.py [--root DIR] [--batches 128,8]
        [--reps 3] [--e2e [--duo 1,0]] [--probes] [--fused]
        [--walls t1,t4,p2,p4 [--wall-reps 2]] [--wall-split 1,2,4]
        [--lookup] [--sketch] [--steps]

Gather: chip_smoke.py's phase 2 case (512 windows of 32 kb from a 10 MB
store) and one launch of E2E_GATHER (one problem a side at about the
E2E run's median row lengths). Each is timed as device time (the C
entry alone, descriptors uploaded once, GATHER_CALLS launches queued
behind a spin on the device) and as the wrapper's time a call,
descriptor packing and upload included. An older commit's one-sided
gather_launch is timed the same way, one launch a side.

Kernels: W = 64, the -xpacbio (combined) scores, the first B of 128
seeded pairs of ~20 kb with ~12% edits (chip_smoke.py's phase 3 set),
for each B of --batches: the traced and the untraced fill and the walk
on the traced fill's buffers, each the median of --reps windows of
CALLS calls timed with CUDA events; then the fill kernels' registers a
thread, read from the built library (cuobjdump --dump-resource-usage).
--fused times D2 (fused_bench): the fill reading the stores against the
fill on rows, ns/step in turns, and one launch against the two-launch
composition (gather, then fill) as device time, at B=128 x 20 kb and
at E2E_FUSED, traced and untraced.
--e2e maps
bench_e2e.make_workload's 100 x 20 kb reads on a 5 Mb genome with -t1
-xpacbio, once for each MINIALIGN_DUO setting of --duo (default "1,0":
the fused duo, then the two-step path): one warm-up, three timed runs
(host clock, ending in a synchronize), then one under torch.profiler,
whose device events give the busy share, the time per kernel (the
fill by width, tracing and source: the fused fill reads the stores) and
the copies by direction; that run also counts the FillEngine.run calls,
each call's fill launches, the requests by kind (duo problems, downs,
ups), the duo's failed downs and the device's peak memory.

--probes times every one-call case of the probes' mains at the tools'
shapes (P1-P4, inputs from seed 0): each case's wrapper and its one
PyTorch call, where there is one, as device time (device_ms, PROBE_CALLS
calls a window) and as a call's host-inclusive time (CUDA events around
PROBE_CALLS calls, as probes._common.Report does), the result held to
the plain twin; the sums per probe; the probe wrapper's stages
(time.perf_counter_ns over STAGE_CALLS calls each); the launch floor (an
empty kernel's device time, and the host time of its ctypes call with
and without the launch and through the probes' launch path); the P2
step timer's ns/step by slope in every dtype at B in STEP_B and n in
STEP_COUNTS; P3's timing loop (every dtype) and P4's stream update at B
in LOOP_B and n in LOOP_COUNTS; and the instruction counts of the probe
kernels and of their loops (cuobjdump -sass).

--walls t1,t4,p2,p4 times the CLI of the --root checkout as a process
on that workload with -xpacbio -1262144 -v2 (chip_smoke.py's phase 9c
batches), --wall-reps times each after one untimed run: "tN" is -tN (N
worker processes here, N threads in a checkout older than the worker
branch), "pN" is -t1 with MINIALIGN_PROC_WORKERS=N; each with the
output's digest without @PG and the merge's remaps. --wall-split 1,2,4
cuts such a run of this checkout into its steps, each in processes of
its own, one after another (wall_split).

--lookup times D3 (the sharded lookup) at chip_smoke.py's phase 9a
shapes: kernel, wrapper, the sharded path as seeding calls it and
torch.searchsorted; with this checkout's design also whole lines
against sectors by the number of queries (lookup_bench).

--sketch times S1 (sketch_bench) at k = 15 on the 5 Mb E2E genome (w =
10) and a 250 Mb one (w = 10, 64, 1024), with the kernel's registers and
SASS; --steps
times P2's step timer alone (step_bench) with its SASS. Each ends the
run after it.

--batches "" leaves the fill and walk out. --root DIR imports
minialign_tpu_torch from DIR instead of this checkout, so that one call
can time two commits on one card (unpack the other with git archive).
Every result is one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

# Run as a file, the script's directory (this package, whose io/ would
# shadow the standard library's) heads sys.path: drop it.
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".")
               != os.path.dirname(os.path.abspath(__file__))]

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from functools import partial  # noqa: E402

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_READS = 100
CALLS = 5       # kernel calls a timed window: ~15-30 ms at 20 kb
GATHER_CALLS = 800   # launches a device-time window (the launch queue
                     # holds ~1,000): ~10 ms at 512 x 32 kb
WRAP_CALLS = 40      # wrapper calls a window (host-bound)
E2E_GATHER = (1, 1, 40960, 20480)   # rows a side, row lengths
E2E_FUSED = (1, 40960, 20480)       # problems, row lengths a side
SIDE = ("base", "start", "cap", "seglen", "wrap")
PROBE_CALLS = 20     # calls a probe window (probes._common.Report.WINDOW)
SKETCH_CALLS = {"E2E genome": 100, "250 Mb genome": 10}  # S1's windows
SKETCH_BENCH_W = (10, 64, 1024)      # S1's w at 250 Mb (the CLI: 10)
STAGE_CALLS = 2000   # calls a wrapper stage is timed over
STEP_B = (128, 1024)                 # step timer columns
STEP_COUNTS = (2048, 2**17)          # step timer n (slope to 2 n)
LOOP_B = (128, 1024)                 # P3's loop and P4's stream columns
LOOP_COUNTS = (2048, 200_000)        # their n (slope to 2 n): the tools'

# Rows that take every path of the gather kernel (csrc/gather.cu): a
# window start at each residue mod 16, windows ending on or near the
# store's last byte or past it, wrap below, at and above the segment
# length and below 16, negative starts, cap 0 and past L, an empty
# segment, a start at or past the segment end.
GATHER_KINDS = ("residue", "store_end", "past_store_end", "wrap_lt",
                "wrap_eq", "wrap_gt", "wrap_tiny", "neg_start",
                "neg_start_wrap", "cap_0", "cap_gt_L", "seglen_0",
                "start_ge_seglen")
# the kinds whose rows neither wrap nor start before their segment: the
# fill in store mode reads them as rows (band.fill_store's general=False)
LINEAR_KINDS = tuple(k for k in GATHER_KINDS
                     if not k.startswith(("wrap", "neg_start")))

# The device sketch's edge cases (S1, csrc/sketch.cu), shared by the CPU
# tests, the card tests and chip_smoke.py's phase 11: every k and w below
# (k = 16 uses all 32 hash bits; w = 128 the last that keeps the window
# index apart from the strand bit; SKETCH_W_WIDE past it, up to the
# kernel's widest), at the lengths of sketch_lengths, on codes of each
# kind: random with N (code 4, taken as A), all A and an AT run (hashes
# that tie), and palindromic k-mers at even k
SKETCH_K = (1, 2, 7, 10, 11, 15, 16)
SKETCH_W = (1, 2, 3, 5, 10, 16, 64, 128)
SKETCH_W_WIDE = (129, 300, 1024)
SKETCH_KINDS = ("random", "all_a", "period2", "palindrome")


def sketch_lengths(k, w, tile):
    """L of the edge cases at (k, w): none, one or two k-mers; position
    counts at the edges of the first two w-blocks (csrc/sketch.cu's van
    Herk blocks: w - 1, w, w + 1, 2w - 1, 2w, 2w + 1); and `tile`
    positions (a block's, cuda_sketch.tile(w)) less one, exact and one
    more, once and twice, and one w-block into the second tile +-1."""
    ns = ({1, 2, w - 1, w, w + 1, 2 * w - 1, 2 * w, 2 * w + 1}
          | {m * tile + d for m in (1, 2) for d in (-1, 0, 1)}
          | {tile + w - 1, tile + w + 1})
    return sorted({0, k - 1} | {n + k - 1 for n in ns if n > 0})


def sketch_codes(rng, kind, L, k):
    """L int8 codes of one SKETCH_KINDS kind."""
    if kind == "random":
        return rng.integers(0, 5, L).astype(np.int8)
    if kind == "all_a":
        return np.zeros(L, np.int8)
    if kind == "period2":
        return np.resize(np.array([0, 3], np.int8), L)
    half = max(k // 2, 1)           # blocks x + revcomp(x), 2 half each
    x = rng.integers(0, 4, (-(-L // (2 * half)), half)).astype(np.int8)
    return np.concatenate([x, (3 - x)[:, ::-1]], 1).reshape(-1)[:L]


def mutate(rng, a, err=0.12):
    """~err edits: 40% substitutions, 30% deletions, 30% insertions."""
    r = rng.random(len(a))
    b = np.where(r < 0.4 * err, rng.integers(0, 4, len(a)), a)
    reps = np.where(r < 0.4 * err, 1, np.where(r < 0.7 * err, 0,
                                               np.where(r < err, 2, 1)))
    out = np.repeat(b, reps)
    ins = np.cumsum(reps)[reps == 2] - 1
    out[ins] = rng.integers(0, 4, len(ins))
    return out


def pairs(band, seed, B, n):
    """B random sequences of ~n bases and their mutated copies, padded
    as band.pad_codes does: (a, alen, b, blen) numpy arrays."""
    rng = np.random.default_rng(seed)
    a = [rng.integers(0, 4, int(rng.normal(n, n * 0.05))) for _ in range(B)]
    b = [mutate(rng, s) for s in a]
    return (*band.pad_codes(a), *band.pad_codes(b))


def combined_scores(ScoreParams):
    """-xpacbio's scoring: match 2, mismatch -4, gi 4, ge 2, gf 3."""
    return ScoreParams(matrix=tuple(2 if (i & 3) == (i >> 2) else -4
                                    for i in range(16)),
                       gi=4, ge=2, gfa=3, gfb=3, xdrop=50)


def gather_store(rng, L):
    """(flat int8 store of codes 0-4, segment bases, segment lengths):
    four segments sized for rows of L columns, the last ending on the
    store's last byte."""
    lens = np.asarray([L // 2 + 7, 3 * L + 13, 2 * L + 5, 2 * L + 9])
    bases = np.concatenate([[0], np.cumsum(lens[:-1])])
    return rng.integers(0, 5, int(lens.sum())).astype(np.int8), bases, lens


def gather_row(kind, rng, bases, lens, L, k=0):
    """One row of GATHER_KINDS on gather_store's segments: (base, start,
    cap, seglen, wrap). k: the residue mod 16 of the window's first byte
    ("residue"), or how far a window ends before ("store_end") or past
    ("past_store_end") the store's last byte."""
    s = {"residue": 1, "store_end": 3, "past_store_end": 3, "wrap_lt": 1,
         "wrap_tiny": 0, "neg_start": 1, "cap_gt_L": 1,
         "start_ge_seglen": 0}.get(kind, 2)
    base, seglen = int(bases[s]), int(lens[s])
    start, cap, wrap = int(rng.integers(0, max(1, seglen - L - 16))), L, 0
    if kind == "residue":
        start += (k - base - start) % 16
        cap = L - int(rng.integers(0, 24))
    elif kind == "store_end":
        start = seglen - L - k
    elif kind == "past_store_end":
        start = seglen - L + k + 1
    elif kind == "wrap_lt":
        wrap = seglen // 3
        start = int(rng.integers(0, seglen))
    elif kind == "wrap_eq":
        wrap = seglen
        start = seglen - int(rng.integers(1, L))
    elif kind == "wrap_gt":
        wrap = seglen + int(rng.integers(1, 100))
        start = seglen - int(rng.integers(1, max(2, L // 2)))
    elif kind == "wrap_tiny":
        wrap = int(rng.integers(1, 40))
    elif kind == "neg_start":
        start = -int(rng.integers(1, 53))
    elif kind == "neg_start_wrap":
        wrap = seglen
        start = -int(rng.integers(1, 2 * L))
    elif kind == "cap_0":
        cap = 0
    elif kind == "cap_gt_L":
        cap = L + int(rng.integers(1, 1000))
    elif kind == "seglen_0":
        seglen, start = 0, int(rng.integers(0, 50))
    elif kind == "start_ge_seglen":
        start = seglen + int(rng.integers(0, 40))
    elif kind not in GATHER_KINDS:
        raise ValueError(f"unknown gather row kind {kind!r}")
    return base, start, cap, seglen, wrap


def gather_side(rng, L, B, kinds=GATHER_KINDS):
    """(store, side) for one side of a two-sided gather: gather_store at
    L and B rows cycling through `kinds` from a random one (k random),
    as the dict of per-row arrays that cuda_gather.pack_desc takes."""
    flat, bases, lens = gather_store(rng, L)
    k0 = int(rng.integers(0, len(kinds)))
    rows = [gather_row(kinds[(k0 + r) % len(kinds)], rng, bases, lens, L,
                       int(rng.integers(0, 16))) for r in range(B)]
    side = dict(zip(SIDE, (np.asarray(x, np.int64) for x in zip(*rows))))
    side["elen"] = np.minimum(side["cap"], L)
    return flat, side


def duo_geometry(seed=3, B=48):
    """{score, mi, mj, rvbase, qub, rlen, qlen, cp0, cp1}: int64 arrays of
    B duo problems for the up-window kernel (dp/duo.py), random ones and,
    in the first rows, each edge case: a failed down (score 0, score < 0),
    tp clipped at 1 and at rlen / qlen, cp at 0, lna_u below tp0 and at
    it, reference and read bases past 2^31, one-base sequences."""
    rng = np.random.default_rng(seed)
    rlen = rng.integers(1, 60000, B)
    qlen = rng.integers(1, 30000, B)
    cols = dict(score=rng.integers(-50, 5000, B), mi=rng.integers(0, 4000, B),
                mj=rng.integers(0, 4000, B), rvbase=rng.integers(0, 2**40, B),
                qub=rng.integers(0, 2**40, B), rlen=rlen, qlen=qlen,
                cp0=rng.integers(0, rlen), cp1=rng.integers(0, qlen))
    edges = [
        dict(score=0),
        dict(score=-7),
        dict(cp0=0, mi=0, cp1=0, mj=0),                # tp clipped at 1
        dict(cp0=0, cp1=0),
        dict(rlen=500, cp0=450, mi=3000),              # tp0 at rlen
        dict(qlen=300, cp1=299, mj=2000),              # tp1 at qlen
        dict(rlen=50000, cp0=40000, mi=100, qlen=20000, cp1=5,
             mj=10),                                   # lna_u < tp0
        dict(rlen=200, cp0=10, mi=20, qlen=20000, cp1=15000,
             mj=100),                                  # lna_u = tp0
        dict(rvbase=2**31, qub=2**31 + 5),
        dict(rvbase=2**35 - 1, qub=2**33, score=0),
        dict(rlen=1, qlen=1, cp0=0, cp1=0, mi=0, mj=0),
    ]
    for k, e in enumerate(edges[:B]):
        for f, v in e.items():
            cols[f][k] = v
    return cols


def duo_fill_case(band, seed, B, n=300):
    """(ab, alen, bb, blen, geometry): B down problems of ~n bases (the
    first two all NCODE at B > 2, so that their downs fail) and
    duo_geometry's edge geometry behind them, with a read and a
    reference past 262 kb (2^18 characters, the TPU kernels' side) in
    rows 11 and 12 where B reaches them."""
    ab, alen, bb, blen = pairs(band, seed, B, n)
    if B > 2:
        ab[:2], alen[:2] = band.NCODE, 0
    c = duo_geometry(seed, B)
    for k, e in ((11, dict(qlen=270_000, cp1=269_990)),
                 (12, dict(rlen=300_000, cp0=150_000, qlen=280_000,
                           cp1=100_000))):
        if k < B:
            for f, v in e.items():
                c[f][k] = v
    return ab, alen, bb, blen, c


def store_case(ab, alen, bb, blen):
    """The store-mode form of padded rows (band.pad_codes): (store_a,
    store_b, desc) numpy arrays, each problem's bases laid end to end in
    its side's store and its rows in the packed descriptor block
    (cuda_gather.pack_desc: start 0, cap = seglen = elen = its length, no
    wrap), so that band.fill_store at the rows' widths reads what
    band.fill reads in the rows."""
    from minialign_tpu_torch.dp import cuda_gather
    stores, sides = [], []
    for rows, lens in ((ab, alen), (bb, blen)):
        lens = np.asarray(lens, np.int64)
        stores.append(np.concatenate([r[:n] for r, n in zip(rows, lens)]
                                     + [np.zeros(1, np.int8)]))
        base = np.concatenate([[0], np.cumsum(lens[:-1])])
        zero = np.zeros(len(lens), np.int64)
        sides.append(dict(base=base, start=zero, cap=lens, seglen=lens,
                          wrap=zero, elen=lens))
    return (*stores, cuda_gather.pack_desc(sides))


def gather_big(seed=1):
    """chip_smoke's phase 2 case: (flat store, side, L), 512 windows of
    32 kb from a 5 Mb (forward + reverse) store, with the segment ends,
    empty windows and circular windows among them."""
    rng = np.random.default_rng(seed)
    G = 5_000_000
    flat = rng.integers(0, 5, 2 * G).astype(np.int8)
    B, L = 512, 32768
    base = rng.integers(0, 2, B) * G
    start = rng.integers(0, G, B)
    start[:4] = [G - 1, G, G - 100, 0]          # the store's segment ends
    cap = rng.integers(L // 2, L + 1, B)
    cap[4:8] = 0                                 # ln = 0
    wrap = np.zeros(B, np.int64)
    wrap[8:40] = G                               # circular windows
    start[8:12] = G - rng.integers(1, 1000, 4)
    side = dict(base=base, start=start, cap=cap, seglen=np.full(B, G),
                wrap=wrap, elen=np.minimum(cap, L))
    return flat, side, L


def gather_read_bytes(side, L):
    """Store bytes a gather must read: each row's selected columns."""
    n = np.minimum(side["cap"], L)
    stay = np.maximum(side["seglen"] - np.maximum(side["start"], 0), 0)
    return int(np.where(side["wrap"] > 0, n, np.minimum(n, stay)).sum())


# The sharded lookup's (D3) edge tables, shared by the CPU tests (against
# the JAX package), the card tests and chip_smoke.py: tests/data/tref.fa's
# index at k = 15 (bucket-major keys, only per-bucket sorted) and k = 19
# (hashes past 2^32), no key at all (one pad slot a shard), and 13 hashes
# past 2^63 with UINT64_MAX among them.
LOOKUP_KINDS = ("tref", "tref_k19", "empty", "high")
U64MAX = np.iinfo(np.uint64).max


def lookup_table(kind, build_index, IndexParams):
    """(keys, offsets) of a LOOKUP_KINDS table, with the given package's
    build_index and IndexParams."""
    if kind in ("tref", "tref_k19"):
        from minialign_tpu_torch.io import bseq
        seqs = list(bseq.read_seqs(os.path.join(HERE, "tests", "data",
                                                "tref.fa")))
        ip = IndexParams(k=19, w=10) if kind == "tref_k19" else IndexParams()
        mi = build_index(ip, [x.name for x in seqs], [x.codes for x in seqs])
        return mi.keys, mi.offsets
    if kind == "empty":
        return np.zeros(0, np.uint64), np.zeros(1, np.uint32)
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1 << 62, 1 << 63, 12, dtype=np.int64)
                     .astype(np.uint64) << np.uint64(1))
    keys = np.concatenate([keys, [U64MAX]]).astype(np.uint64)
    rng.shuffle(keys)
    off = np.concatenate([[0], np.cumsum(rng.integers(1, 5, len(keys)))])
    return keys, off.astype(np.uint32)


def lookup_queries(keys, seed=5):
    """Every key, misses between and around them, 0, the pad value, the
    sign bit's edges, a hash below the first key and one above the last,
    shuffled."""
    k = np.sort(np.asarray(keys, np.uint64))
    extra = [0, 1, U64MAX, U64MAX - 1, 1 << 63, (1 << 63) - 1]
    if len(k):
        extra += [int(k[0]) - 1 if k[0] else 0, min(int(k[-1]) + 1, U64MAX)]
    q = np.concatenate([k, k[: len(k) // 2] + np.uint64(1),
                        np.asarray(extra, np.uint64)])
    return np.random.default_rng(seed).permutation(q)


# Shard sizes around one leaf block of D3's search tree (15 keys), one
# node (16), one node's children (17) and their powers
# (parallel/cuda_lookup.py)
LOOKUP_EDGE_K = (1, 15, 16, 17, 255, 256, 257, 4097)


def lookup_edge_tables(K, n, seed=0):
    """(keys_sh, starts_sh, counts_sh) of n shards of K keys, laid out as
    shard_index_arrays lays out a table (sorted, hash ranges in shard
    order, UINT64_MAX and zeros after the last key), with fewer keys than
    slots so that a shard is part pad and, at n > 1, the last all pad;
    half the keys below 2^33, the rest anywhere in 64 bits."""
    rng = np.random.default_rng(seed)
    T = max(1, K * (n - 1) - K // 2) if n > 1 else K - K // 3
    keys = np.unique(np.concatenate([
        rng.integers(0, 1 << 33, T, dtype=np.uint64),
        rng.integers(0, U64MAX, T, dtype=np.uint64, endpoint=True)]))
    keys = np.sort(rng.permutation(keys)[:T])
    T = len(keys)
    cn = rng.integers(1, 5, T)
    st = np.concatenate([[0], np.cumsum(cn)[:-1]])
    out = []
    for x, pad in ((keys, U64MAX), (st, 0), (cn, 0)):
        full = np.full(K * n, pad, x.dtype)
        full[:T] = x
        out.append(full.reshape(n, K))
    return out


def lookup_edge_queries(keys_sh, seed=1):
    """Every key of the table, its neighbours, 0, the pad value, the
    edges of 2^32 and of the sign bit, and some queries twice,
    shuffled."""
    k = np.unique(np.asarray(keys_sh, np.uint64))
    k = k[k != U64MAX]
    extra = np.asarray([0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1,
                        1 << 63, U64MAX - 1, U64MAX, U64MAX], np.uint64)
    q = np.concatenate([k, k + np.uint64(1), k - np.uint64(1), extra,
                        k[:7], k[-3:]])
    return np.random.default_rng(seed).permutation(q)


def lookup_cases(build_index, IndexParams, shards=(1, 2, 8)):
    """(name, n, tables, queries) of every D3 edge case: the
    LOOKUP_KINDS tables and the LOOKUP_EDGE_K shard sizes, each split
    over each shard count."""
    from minialign_tpu_torch.parallel.shard import shard_index_arrays
    for kind in LOOKUP_KINDS:
        keys, off = lookup_table(kind, build_index, IndexParams)
        for n in shards:
            yield (kind, n, shard_index_arrays(keys, off, n),
                   lookup_queries(keys))
    for K in LOOKUP_EDGE_K:
        for n in shards:
            tabs = lookup_edge_tables(K, n, seed=K * 10 + n)
            yield (f"K={K}", n, tabs, lookup_edge_queries(tabs[0]))


def lookup_tensors(torch, tabs, q, device):
    """shard_index_arrays' numpy tables and the query hashes as the
    lookup kernel takes them: int64 tensors (the uint64 bits) on
    `device`."""
    def t(x):
        x = np.ascontiguousarray(x)
        return torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64
                                else x.astype(np.int64)).to(device)
    return [t(x) for x in tabs] + [t(np.asarray(q, np.uint64))]


def lookup_bytes(keys_sh, q, found):
    """Bytes the sharded lookup must move for these inputs: the queries,
    the distinct keys the searches probe (each read once: the top levels
    are shared by every query), the start and count of each hit, and the
    (S, Q) starts and counts written."""
    S, K = keys_sh.shape
    q = np.asarray(q, np.uint64)
    probed = []
    for s in range(S):
        lo = np.zeros(len(q), np.int64)
        n = np.full(len(q), K, np.int64)
        while (n > 0).any():
            live = n > 0
            half = n >> 1
            mid = np.minimum(lo + half, K - 1)
            probed.append(s * K + mid[live])
            less = live & (keys_sh[s, mid] < q)
            lo = np.where(less, lo + half + 1, lo)
            n = np.where(less, n - half - 1, np.where(live, half, 0))
        probed.append(s * K + np.minimum(lo, K - 1))
    n_keys = len(np.unique(np.concatenate(probed)))
    return 8 * len(q) + 8 * n_keys + 16 * int(found) + 16 * S * len(q)


def lookup_ops(keys_sh, q):
    """32-bit operations of the searches: ~4 a level (two 32-bit halves
    of a 64-bit compare, the select, the halving), ceil(log2(K + 1))
    levels a (shard, query) pair, and 4 for the found test and writes."""
    S, K = keys_sh.shape
    return S * len(q) * (4 * int(np.ceil(np.log2(K + 1))) + 4)


def lookup_shapes(mi, reads, seed=9):
    """[(name, keys, offsets, queries)] of D3's timed shapes: "read", the
    median read's minimizer hashes against the index mi (the main path's
    shape: seeding looks up one read a call, chain.collect_seeds);
    "e2e", every read's hashes in one launch; "big", 10^5 queries (half
    hits) against 10^7 random keys (80 MB, past L2). Each table is
    split 2 ways by the caller."""
    from minialign_tpu_torch.index.sketch import sketch
    per_read = sorted((sketch(np.asarray(c, np.int64) & 3, mi.k, mi.w)[0]
                       for c in reads), key=len)
    rng = np.random.default_rng(seed)
    big_keys = np.unique(rng.integers(0, U64MAX, 10_200_000,
                                      dtype=np.uint64))[:10_000_000]
    rng.shuffle(big_keys)
    big_off = np.concatenate([[0], np.cumsum(rng.integers(
        1, 5, len(big_keys)))]).astype(np.uint32)
    big_q = np.concatenate([rng.choice(big_keys, 50_000),
                            rng.integers(0, U64MAX, 50_000,
                                         dtype=np.uint64)])
    return [("read", mi.keys, mi.offsets,
             np.asarray(per_read[len(per_read) // 2], np.uint64)),
            ("e2e", mi.keys, mi.offsets,
             np.concatenate(per_read).astype(np.uint64)),
            ("big", big_keys, big_off, big_q)]


def lookup_timing(torch, tabs, q, dev, split=None, library=True):
    """({ms, wrapper_ms, library_ms, ...}, (2, Q) result, (keys, starts,
    counts, queries) on the device) of the loaded package's D3 on
    shard_index_arrays' tables `tabs` and the query hashes q on device
    dev: the C entry's device time (device_ms, 20 launches a window),
    the wrapper's time a call with the queries on the device (CUDA
    events, 20 calls a window) and torch.searchsorted on the same
    sign-flipped table (device time). This commit's design takes the
    tree (built once, not timed) and split (default: the wrapper's); an
    older commit's takes the (S, K) tables, and its (S, Q) rows come
    back summed."""
    from minialign_tpu_torch import _build
    from minialign_tpu_torch.parallel import cuda_lookup as cl
    kt, st, ct, qt = lookup_tensors(torch, tabs, q, dev)
    S, K = kt.shape
    Q = len(q)
    lib = _build.library()
    stream = _build.stream_of(kt)
    if hasattr(cl, "build_tree"):
        tree = cl.build_tree(kt, st, ct)
        if split is None:
            split = cl.use_split(
                S, K, Q, torch.cuda.get_device_properties(dev).L2_cache_size)
        out = torch.empty((2, Q), dtype=torch.int64, device=dev)
        ptrs = (tree.leaf.data_ptr(), tree.nodes.data_ptr(),
                tree.leaf_sums.data_ptr(), tree.node_sums.data_ptr(),
                tree.pairs.data_ptr(), tree.bounds.data_ptr(), S, K,
                qt.data_ptr(), Q, out.data_ptr(), int(split), dev.index,
                stream)
        run = lambda: cl.lookup(tree, qt, split)  # noqa: E731
        levels = cl.smem_levels(S, K, split)
        extra = dict(levels=levels, split=split, tree_levels=tree.levels,
                     tree_bytes=tree.nbytes(),
                     smem_bytes=cl.smem_bytes(S, K, levels, split))
    else:
        so = torch.empty((S, Q), dtype=torch.int64, device=dev)
        co = torch.empty_like(so)
        ptrs = (kt.data_ptr(), st.data_ptr(), ct.data_ptr(), S, K,
                qt.data_ptr(), Q, so.data_ptr(), co.data_ptr(), stream)
        run = lambda: cl.lookup(kt, st, ct, qt)  # noqa: E731
        extra = {}
    ms = device_ms(torch, lambda: lib.lookup_launch(*ptrs), calls=20)
    got = run()
    _, wms = timed(torch, run, 3, 20)
    if isinstance(got, tuple):
        got = torch.stack([got[0].sum(0), got[1].sum(0)])
    res = dict(ms=ms, wrapper_ms=wms, **extra)
    if library:
        kf = kt ^ cl.SIGN
        qf = (qt ^ cl.SIGN)[None, :].expand(S, -1).contiguous()
        res["library_ms"] = device_ms(
            torch, lambda: torch.searchsorted(kf, qf), calls=20)
    return res, got, (kt, st, ct, qt)


def lookup_want(torch, kt, st, ct, qt):
    """The plain version's (2, Q) sum over the shards on the (S, K)
    tables themselves (cuda_lookup.lookup_plain, which every commit's
    package has), for holding either design's kernel to."""
    from minialign_tpu_torch.parallel import cuda_lookup as cl
    p_st, p_cn = cl.lookup_plain(kt, st, ct, qt)
    return torch.stack([p_st.sum(0), p_cn.sum(0)])


def lookup_path_ms(torch, tabs, q, dev, calls=50):
    """Host ms a call of the sharded index's lookup as seeding calls it
    (ShardedIndex.lookup's body: numpy hashes in, the shards' sums read
    back to the host), the tables on [dev, dev], and of its first stages
    alone: {"upload": the hashes' upload, "launch": the upload and the
    lookup's launches, "path": all of it}, each the median of 3 windows
    of `calls` calls on the host clock, each call waiting on the device
    (a synchronize, or the path's own read-back)."""
    from minialign_tpu_torch.dp.cuda_gather import upload
    from minialign_tpu_torch.parallel import cuda_lookup as cl
    from minialign_tpu_torch.parallel import shard
    mesh = [dev, dev]
    tables = shard.place_shards(mesh, *tabs)
    qh = np.ascontiguousarray(q, np.uint64).view(np.int64)

    def path():
        r = shard.sharded_lookup(mesh, tables, q)
        return [x.cpu() for x in r] if isinstance(r, tuple) else r.cpu()

    def up():
        upload(qh, dev)
        torch.cuda.synchronize()

    def launch():
        t = upload(qh, dev)
        if hasattr(cl, "build_tree"):
            cl.lookup(tables[0], t)
        else:
            cl.lookup(*tables[0], t)
        torch.cuda.synchronize()

    out = {}
    for name, fn in (("upload", up), ("launch", launch), ("path", path)):
        fn()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            ts.append((time.perf_counter() - t0) * 1e3 / calls)
        out[name] = sorted(ts)[1]
    return out


def lookup_bench(torch, pkg, emit):
    """D3 at lookup_shapes' three shapes (the E2E workload's index and
    reads, -xpacbio), each table split 2 ways on one card: the loaded
    package's kernel, wrapper, sharded path and torch.searchsorted
    (lookup_timing, lookup_path_ms), held to the plain version; for this
    commit's design also whole lines against sectors by the number of
    queries, where use_split switches (device time, each held to the
    plain version too)."""
    from minialign_tpu_torch import cli
    from minialign_tpu_torch.index.build import build_index
    from minialign_tpu_torch.io import bseq
    from minialign_tpu_torch.parallel import cuda_lookup as cl
    from minialign_tpu_torch.parallel import shard
    dev = torch.device("cuda", torch.cuda.current_device())
    ref_fa, reads_fq, _ = e2e_workload()
    o = cli.Opts()
    cli.parse_argv(o, ["-xpacbio"])
    cli.finalize(o)
    ip, _ = cli.make_params(o)
    ref = list(bseq.read_seqs(ref_fa))
    mi = build_index(ip, [x.name for x in ref], [x.codes for x in ref])
    reads = [x.codes for x in bseq.read_seqs(reads_fq)]
    for name, keys, off, q in lookup_shapes(mi, reads):
        tabs = shard.shard_index_arrays(keys, off, 2)
        res, got, t = lookup_timing(torch, tabs, q, dev)
        want = lookup_want(torch, *t)
        row = dict(kind="lookup", pkg=pkg, shape=name, queries=len(q),
                   keys=len(keys), equal=bool(torch.equal(got, want)),
                   **res)
        if name == "read":
            row["path_ms"] = lookup_path_ms(torch, tabs, q, dev)
        emit(**row)
        if name == "e2e" and hasattr(cl, "build_tree"):
            for n in (1 << 10, 1 << 12, 1 << 14, 1 << 15, 1 << 16, 1 << 17):
                for split in (False, True):
                    r, g, _ = lookup_timing(torch, tabs, q[:n], dev,
                                            split=split, library=False)
                    emit(kind="lookup_split", pkg=pkg, queries=n,
                         split=split, ms=r["ms"],
                         equal=bool(torch.equal(g, want[:, :n])))
        del got, want, t


def write_split_reads(paths, batch, seed=11):
    """Two read files of ~1 kb slices of tests/data/tref.fa with ~7%
    edits, either strand: the first holds one batch at -1<batch>
    (bseq.read_batches closes a batch at `batch` bases) and two reads
    more, the second three reads. Mapped with -1<batch>, the plan has
    three batches: a full one, then two short ones."""
    with open(os.path.join(HERE, "tests", "data", "tref.fa")) as f:
        ref = "".join(line.strip() for line in f if not line.startswith(">"))
    rng = np.random.default_rng(seed)
    comp = str.maketrans("ACGT", "TGCA")

    def read():
        L = int(rng.integers(900, 1100))
        st = int(rng.integers(0, len(ref) - L))
        out = []
        for c in ref[st:st + L]:
            r = rng.random()
            if r < 0.03:
                out.append("ACGT"[rng.integers(0, 4)])
            elif r >= 0.05:
                out.append(c)
                if r < 0.07:
                    out.append("ACGT"[rng.integers(0, 4)])
        s = "".join(out)
        return s.translate(comp)[::-1] if rng.random() < 0.5 else s

    full = []
    while sum(map(len, full)) < batch:
        full.append(read())
    n = 0
    for path, reads in zip(paths, (full + [read(), read()],
                                   [read(), read(), read()])):
        with open(path, "w") as f:
            for s in reads:
                f.write(f"@r{n}\n{s}\n+\n{'I' * len(s)}\n")
                n += 1


def device_ms(torch, fn, reps=3, calls=GATHER_CALLS):
    """Device ms a call of fn (a bare kernel launch through its C entry,
    returning the CUDA error code, or a wrapper or PyTorch call that
    returns a tensor): the median of `reps` windows of `calls` calls
    between CUDA events, queued behind a spin on the device
    (torch.cuda._sleep, twice the host's time for a window plus 2 ms) so
    that a window holds the kernels back to back and not the host's
    launch rate. One warm-up call first."""
    rc = fn()
    if isinstance(rc, int) and rc != 0:
        raise RuntimeError("kernel launch failed")
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int((2 * host + 0.002) * 2e9))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / calls)
    return sorted(ts)[len(ts) // 2]


def gather_times(torch, stores, sides, Ls):
    """(device ms a launch, wrapper ms a call, rows) of the loaded
    package's gather on one or two sides (stores, sides and row lengths
    as lists). This commit's gather_pair_launch takes both sides in one
    launch; an older commit's gather_launch takes one launch a side. The
    rows are checked against gather_plain."""
    from minialign_tpu_torch import _build
    from minialign_tpu_torch.dp import cuda_gather
    lib = _build.library()
    dev = stores[0].device
    stream = _build.stream_of(stores[0])
    outs = [torch.empty((len(s["base"]), L), dtype=torch.int8, device=dev)
            for s, L in zip(sides, Ls)]
    if hasattr(lib, "gather_pair_launch"):
        sa, sb = stores[0], stores[-1]
        Ba = len(sides[0]["base"])
        Lb = Ls[-1] if len(sides) == 2 else 0
        desc = torch.from_numpy(cuda_gather.pack_desc(sides)).to(dev)
        args = (sa.data_ptr(), sa.numel(), sb.data_ptr(), sb.numel(),
                desc.data_ptr(), Ba, len(desc) // cuda_gather.WORDS - Ba,
                Ls[0], Lb, outs[0].data_ptr(), outs[-1].data_ptr(), stream)
        launch = lambda: lib.gather_pair_launch(*args)  # noqa: E731

        def wrapper():
            blk = cuda_gather.upload(cuda_gather.pack_desc(sides), dev)
            return cuda_gather.gather_pair(sa, sb, blk, Ba, Ls[0], Lb)
    else:
        metas = [[torch.as_tensor(s[k], dtype=torch.int64 if k == "base"
                                  else torch.int32, device=dev)
                  for k in SIDE] for s in sides]
        calls = [(st.data_ptr(), *(m.data_ptr() for m in meta),
                  len(s["base"]), L, o.data_ptr(), stream)
                 for st, meta, s, L, o in zip(stores, metas, sides, Ls,
                                              outs)]

        def launch():
            return max(lib.gather_launch(*c) for c in calls)

        def wrapper():
            return [cuda_gather.gather(st, *(s[k] for k in SIDE), L)
                    for st, s, L in zip(stores, sides, Ls)]
    ms = device_ms(torch, launch)
    wrapper()                                     # warm-up: allocations
    _, wms = timed(torch, wrapper, 3, WRAP_CALLS)
    for st, s, L, o in zip(stores, sides, Ls, outs):
        want = cuda_gather.gather_plain(st, *(s[k] for k in SIDE), L)
        if not torch.equal(o, want):
            raise RuntimeError("gather kernel != gather_plain")
    return ms, wms, outs


def gather_bench(torch, pkg, shape, emit):
    """Emits the gather's times on gather_big and on one launch of
    `shape` (Ba, Bb, La, Lb) of gather_side rows."""
    from minialign_tpu_torch.dp import cuda_gather
    dev = torch.device("cuda")
    # an older commit has no pad_store: its kernel reads bytes singly
    pad = getattr(cuda_gather, "pad_store", lambda f: f)
    flat, side, L = gather_big()
    store = torch.from_numpy(pad(flat)).to(dev)
    ms, wms, _ = gather_times(torch, [store], [side], [L])
    nbytes = len(side["base"]) * L + gather_read_bytes(side, L)
    emit(kind="gather", pkg=pkg, rows=len(side["base"]), L=L, ms=ms,
         wrapper_ms=wms, bytes=nbytes, gb_per_s=nbytes / ms / 1e6)
    Ba, Bb, La, Lb = shape
    rng = np.random.default_rng(3)
    stores, sides = [], []
    for B, Lx in ((Ba, La), (Bb, Lb)):
        f, s = gather_side(rng, Lx, B, kinds=("residue",))
        stores.append(torch.from_numpy(pad(f)).to(dev))
        sides.append(s)
    ms, wms, _ = gather_times(torch, stores, sides, [La, Lb])
    emit(kind="gather", pkg=pkg, rows=[Ba, Bb], L=[La, Lb], ms=ms,
         wrapper_ms=wms)


def timed(torch, fn, reps=1, calls=1):
    """(result, median ms a call) of fn() over reps windows of `calls`
    calls each, CUDA events around each window (calls > 1 keeps a window
    at tens of ms for a kernel of a few)."""
    out, ts = None, []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            out = fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / calls)
    return out, sorted(ts)[len(ts) // 2]


# P1's and P2's edge inputs, shared by the CPU tests (against the JAX
# tools), the card tests and chip_smoke.py: values at the types' edges
# (probe_edge_values), a shape whose size is no multiple of 16, and
# views one value past an aligned start (the kernel's scalar path).
PROBE_EDGE_KINDS = ("extreme", "odd", "offset")
PROBE_ODD_SHAPE = (7, 37)
# by dtype, two ranges; each value is drawn from one of them at random:
# int8 and int16 at both ends (adds wrap, compares cross the sign), uint8
# on both sides of 128 (compares are unsigned), int32 at both ends, bf16
# and float32 integers whose sums round to the type
PROBE_EDGE_RANGES = {
    "int8": ((-128, -100), (100, 128)),
    "uint8": ((0, 128), (128, 256)),
    "int16": ((-32768, -32700), (32700, 32768)),
    "int32": ((-2**31, -2**31 + 1000), (2**31 - 1000, 2**31)),
    "bfloat16": ((-3000, -200), (200, 3000)),
    "float32": ((-2**25, -2**24), (2**24, 2**25)),
}


def probe_edge_values(rng, dtype, shape):
    """Integers (numpy int64) of `shape`, each from one of dtype's two
    PROBE_EDGE_RANGES at random."""
    (a, b), (c, d) = PROBE_EDGE_RANGES[dtype]
    return np.where(rng.random(shape) < 0.5, rng.integers(a, b, shape),
                    rng.integers(c, d, shape))


def probe_edge_pair(rng, dtype, kind, device, shape=(64, 128)):
    """x, y for P1 / P2 of an edge kind: "extreme" probe_edge_values at
    `shape`, "odd" at PROBE_ODD_SHAPE, "offset" at `shape` as views that
    start one value into their storage (not 16-byte aligned)."""
    from minialign_tpu_torch.probes._common import tensor
    if kind not in PROBE_EDGE_KINDS:
        raise ValueError(f"unknown edge kind {kind!r}")
    if kind == "odd":
        shape = PROBE_ODD_SHAPE
    n = int(np.prod(shape))
    out = []
    for _ in range(2):
        if kind == "offset":
            t = tensor(probe_edge_values(rng, dtype, (n + 1,)), dtype, device)
            out.append(t[1:].view(shape))
        else:
            out.append(tensor(probe_edge_values(rng, dtype, shape), dtype,
                              device))
    return out


# P3's timing loop and P4's stream and roll on edge inputs, shared by the
# CPU models (tests/test_torch_probe_stream.py), the card tests and
# chip_smoke.py phase 7: step counts around the stream's 7-step pass,
# column counts that leave part of a warp idle, directions that never or
# always move stream b (d outside [0, 7)), words over the whole int32
# range (the sign bit set in half), and P3's types at their ends
# (PROBE_EDGE_RANGES: int32 and int16 adds that wrap, bf16 past 256).
LOOP_EDGE_STEPS = (0, 1, 6, 7, 8, 2048 + 3)
LOOP_EDGE_C = (1, 33, 128)
STREAM_D_KINDS = ("mixed", "never", "always")
ROLL_EDGE_ROUNDS = (0, 1, 11, 64, 65)
P3_EDGE_DTYPES = ("int32", "float32", "bfloat16", "int16", "int8")


def stream_edge_case(rng, C, kind, device):
    """wa, wb (8, C) int32 drawn over the whole int32 range and d (1, C):
    "mixed" from [-2, 10), "never" from [-5, 1) (d > i % 7 never holds),
    "always" from [7, 12) (it always holds)."""
    from minialign_tpu_torch.probes._common import tensor
    lo, hi = {"mixed": (-2, 10), "never": (-5, 1), "always": (7, 12)}[kind]
    wa, wb = (tensor(rng.integers(-2**31, 2**31, (8, C)), "int32", device)
              for _ in range(2))
    return wa, wb, tensor(rng.integers(lo, hi, (1, C)), "int32", device)


def timing_edge_input(rng, dtype, B, device):
    """x (64, B) for P3's timing loop at the dtype's ends."""
    from minialign_tpu_torch.probes._common import tensor
    return tensor(probe_edge_values(rng, dtype, (64, B)), dtype, device)


def probe_cases(dev, rng):
    """(probe, case, run, library or None, plain, work) for every one-call
    case of the probes' mains (P1: probe_subint32's 18, P2:
    probe_lowprec's 30, P3: probe_bf16ops' 10, P4: probe_wordstream's 3
    primitives), at the tools' shapes, inputs drawn from rng as the mains
    draw them; work is the case's (inputs, operations per output
    element), as the mains give it to probes._common.Report.case."""
    from minialign_tpu_torch.probes import (_common, bf16ops, lowprec,
                                            subint32, wordstream)
    lib = _common.LIBRARY_BINOP
    cases = []
    for dt in subint32.DTYPES:
        for op in subint32.BINOPS:
            x, y = _common.inputs(rng, dt, dev, *subint32.RANGE)
            cases.append(("p1", f"{dt} {op}",
                          partial(subint32.probe, op, x, y, dev),
                          partial(lib[op], x, y),
                          partial(subint32.probe_plain, op, x, y),
                          ((x, y), 1)))
        for op in subint32.CARRY_OPS:
            x, y = _common.inputs(rng, dt, dev, *subint32.RANGE)
            cases.append(("p1", f"carry {dt} {op}",
                          partial(subint32.probe_carry, op, x, y, dev), None,
                          partial(subint32.probe_carry_plain, op, x, y),
                          ((x, y), subint32.ROUNDS)))
    for dt in lowprec.DTYPES:
        for op in lowprec.BINOPS:
            x, y = _common.inputs(rng, dt, dev)
            cases.append(("p2", f"{dt} {op}",
                          partial(lowprec.elementwise, op, x, y, dev),
                          partial(lib[op], x, y),
                          partial(lowprec.elementwise_plain, op, x, y),
                          ((x, y), 1)))
        x, y = _common.inputs(rng, dt, dev)
        cases.append(("p2", f"{dt} max-in-carry",
                      partial(lowprec.in_carry, "maximum", x, y, dev), None,
                      partial(lowprec.in_carry_plain, "maximum", x, y),
                      ((x, y), lowprec.ROUNDS)))
        x, y = _common.inputs(rng, dt, dev)
        cases.append(("p2", f"{dt} roll-sel-in-carry",
                      partial(lowprec.roll_concat, x, y, dev), None,
                      partial(lowprec.roll_concat_plain, x, y),
                      ((x, y), 3 * lowprec.ROUNDS)))
    for op, name, dt in bf16ops.OPS:
        x, y = _common.inputs(rng, dt, dev)
        one = bf16ops.LIBRARY.get(op)
        cases.append(("p3", name, partial(bf16ops.run2, op, x, y, dev),
                      one and partial(one, x, y),
                      partial(bf16ops.run2_plain, op, x, y),
                      ((x, y), bf16ops.OP_COST[op])))
    shape = wordstream.SHAPE
    w = _common.tensor(rng.integers(0, 2**30, shape), "int32", dev)
    s = _common.tensor(rng.integers(0, 10, shape), "int32", dev)
    v = _common.tensor(rng.integers(0, 2**18, shape), "int32", dev)
    for name, fn, args, ops in (
            ("var_shift", wordstream.var_shift, (w, s), 3),
            ("roll_in_carry", wordstream.roll_in_carry, (w,),
             2 * wordstream.ROLL_ROUNDS),
            ("div10_magic", wordstream.div10_magic, (v,), 3)):
        cases.append(("p4", name, partial(fn, *args, device=dev), None,
                      partial(getattr(wordstream, f"{name}_plain"), *args),
                      (args, ops)))
    return cases


def probes_bench(torch, pkg, emit):
    """Emits each case of probe_cases (device and host-inclusive ms a
    call of the wrapper and of its one PyTorch call, the result held to
    the plain twin, the case's bound), then the sums per probe over all
    its cases and over the cases that have a PyTorch call (kernel_*,
    library_*: device time and bound over the same cases)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    sums = {}
    from minialign_tpu_torch.probes._common import bound_ms
    for probe, case, run, library, plain, (ins, ops) in probe_cases(
            dev, np.random.default_rng(0)):
        got = run()
        row = dict(kernel=probe, case=case,
                   equal=bool(torch.equal(got, plain())),
                   device_ms=device_ms(torch, run, calls=PROBE_CALLS),
                   host_ms=timed(torch, run, 3, PROBE_CALLS)[1],
                   bound_ms=max(bound_ms(
                       sum(x.numel() * x.element_size() for x in ins)
                       + got.numel() * got.element_size(),
                       got.numel() * ops)))
        if library is not None:
            library()
            row.update(library_device_ms=device_ms(torch, library,
                                                   calls=PROBE_CALLS),
                       library_host_ms=timed(torch, library, 3,
                                             PROBE_CALLS)[1])
        emit(kind="probe", pkg=pkg, **row)
        s = sums.setdefault(probe, dict(
            cases=0, equal=0, device_ms=0.0, host_ms=0.0, bound_ms=0.0,
            library_cases=0, kernel_device_ms=0.0, kernel_host_ms=0.0,
            library_device_ms=0.0, library_host_ms=0.0,
            library_bound_ms=0.0))
        s["cases"] += 1
        s["equal"] += row["equal"]
        s["device_ms"] += row["device_ms"]
        s["host_ms"] += row["host_ms"]
        s["bound_ms"] += row["bound_ms"]
        if library is not None:
            s["library_cases"] += 1
            s["library_bound_ms"] += row["bound_ms"]
            s["kernel_device_ms"] += row["device_ms"]
            s["kernel_host_ms"] += row["host_ms"]
            s["library_device_ms"] += row["library_device_ms"]
            s["library_host_ms"] += row["library_host_ms"]
    for probe, s in sums.items():
        lc = s["library_cases"]
        emit(kind="probe_sum", pkg=pkg, kernel=probe, **s, **(dict(
            device_ratio=s["kernel_device_ms"] / s["library_device_ms"],
            host_ratio=s["kernel_host_ms"] / s["library_host_ms"])
            if lc else {}))


def stage_ns(torch, fn, calls=None):
    """ns a call of fn over `calls` calls on the host clock
    (time.perf_counter_ns), after one warm-up call and a synchronize."""
    calls = calls or STAGE_CALLS
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    ns = (time.perf_counter_ns() - t0) / calls
    torch.cuda.synchronize()
    return ns


def wrapper_stages(torch, pkg, emit):
    """Emits the host ns a call of each stage of the probe wrapper on P1's
    int8 add at (64, 128), of the whole wrapper, of torch.add on the same
    tensors and of an empty call ("loop", the timing loop's own cost).
    The stages are those of the loaded package's launch path: the older
    one (on, on_kernel, torch.empty, the torch.cuda.device context, the
    Stream object's handle, the ctypes call) or the thin one (on,
    kernel_for, the checks, torch.empty_like, the device index, the entry
    lookup, the raw stream handle, the ctypes call); count and check in
    both."""
    from minialign_tpu_torch import _build
    from minialign_tpu_torch.probes import _common, subint32
    dev = torch.device("cuda", torch.cuda.current_device())
    x, y = _common.inputs(np.random.default_rng(2), "int8", dev,
                          *subint32.RANGE)
    lib = _build.library()
    out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    code = _common.CODE[x.dtype]
    ptrs = (x.data_ptr(), y.data_ptr(), x.numel(), code, 0, 0,
            out.data_ptr())
    st = {"loop": lambda: None, "on": lambda: _common.on(dev, x, y)}
    if hasattr(_common, "raw_stream"):           # the thin launch path
        idx = x.get_device()
        fn = _common.entry("p1_probe_launch")
        stream = _common.raw_stream(idx)
        st.update({
            "kernel_for": lambda: _common.kernel_for(x),
            "checks": lambda: _common.binop_checks("p1", "add", x, y),
            "torch.empty_like": lambda: torch.empty_like(
                x, dtype=torch.int32),
            "data_ptr x3": lambda: (x.data_ptr(), y.data_ptr(),
                                    out.data_ptr()),
            "get_device": lambda: x.get_device(),
            "entry lookup": lambda: _common.entry("p1_probe_launch"),
            "stream lookup": lambda: _common.raw_stream(idx),
            "ctypes call": lambda: fn(*ptrs, idx, stream)})
    else:                                        # the older launch path
        stream = torch.cuda.current_stream(dev).cuda_stream

        def context():
            with torch.cuda.device(dev):
                pass
        st.update({
            "on_kernel": lambda: _common.on_kernel(dev),
            "torch.empty": lambda: torch.empty(x.shape, dtype=torch.int32,
                                               device=x.device),
            "data_ptr x3": lambda: (x.data_ptr(), y.data_ptr(),
                                    out.data_ptr()),
            "device context": context,
            "stream lookup": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "ctypes call": lambda: lib.p1_probe_launch(*ptrs, stream)})
    st.update({"count": lambda: _build.count("p1"),
               "check": lambda: _build.check(lib, 0, "p1"),
               "wrapper": lambda: subint32.probe("add", x, y, dev),
               "torch.add": lambda: torch.add(x, y)})
    emit(kind="wrapper_stages", pkg=pkg, case="p1 int8 add (64, 128)",
         calls=STAGE_CALLS, ns={k: stage_ns(torch, f) for k, f in st.items()})
    _build.reset_counts()


def step_bench(torch, pkg, emit):
    """Emits the P2 step timer's ns/step (lowprec.step_timer: slope
    between n and 2 n, fastest of its reps) for each dtype of
    lowprec.STEP_DTYPES at each B of STEP_B and n of STEP_COUNTS, after
    holding the kernel to step_timer_plain at 64 steps."""
    from minialign_tpu_torch.probes import lowprec
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(3)
    for dt in lowprec.STEP_DTYPES:
        for B in STEP_B:
            x, dd = lowprec.step_inputs(rng, dt, dev, B)
            equal = bool(torch.equal(lowprec.step_loop(x, dd, 64, dev),
                                     lowprec.step_timer_plain(x, dd, 64)))
            ts = {n: lowprec.step_timer(x, dd, n, dev) for n in STEP_COUNTS}
            bound = getattr(lowprec, "step_bound_ns", None)
            emit(kind="step_timer", pkg=pkg, dtype=dt, B=B,
                 equal_at_64=equal,
                 ns_per_step={n: t.ns_per_step for n, t in ts.items()},
                 t1_ms={n: t.t1_ms for n, t in ts.items()},
                 bound_ns=bound(dt, B) if bound else None)


def loop_bench(torch, pkg, emit):
    """Emits the ns/step (slope between n and 2 n, fastest of the reps) of
    P3's timing loop in each dtype of bf16ops.TIMING_DTYPES and of P4's
    stream update, at each B (columns) of LOOP_B and n of LOOP_COUNTS,
    after holding each to its plain twin at 64 steps; P3's beside its
    bound a step (bf16ops.timing_bound_ns)."""
    from minialign_tpu_torch.probes import _common, bf16ops, wordstream
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(4)

    def bench(kind, dtype, B, run, plain, timer, bound_ns=None):
        equal = bool(torch.equal(run(64), plain(64)))
        ts = {n: timer(n) for n in LOOP_COUNTS}
        emit(kind=kind, pkg=pkg, dtype=dtype, B=B, equal_at_64=equal,
             ns_per_step={n: t.ns_per_step for n, t in ts.items()},
             t1_ms={n: t.t1_ms for n, t in ts.items()}, bound_ns=bound_ns)

    bound = getattr(bf16ops, "timing_bound_ns", None)
    for dt in bf16ops.TIMING_DTYPES:
        for B in LOOP_B:
            x = bf16ops.timing_input(rng, dt, dev, B)
            bench("p3_loop", dt, B,
                  lambda n: bf16ops.timing_loop(x, n, dev),
                  lambda n: bf16ops.timing_plain(x, n),
                  lambda n: bf16ops.timing(x, n, dev),
                  bound(dt, B) if bound else None)
    for B in LOOP_B:
        wa, wb = (_common.tensor(rng.integers(0, 2**30, (8, B)), "int32",
                                 dev) for _ in range(2))
        d = _common.tensor(rng.integers(0, 7, (1, B)), "int32", dev)
        bench("p4_stream", "int32", B,
              lambda n: wordstream.stream_loop(wa, wb, d, n, dev),
              lambda n: wordstream.stream_timing_plain(wa, wb, d, n),
              lambda n: wordstream.stream_timing(wa, wb, d, n, dev))


def launch_floor(torch, pkg, emit):
    """Emits the probes' launch floor: the empty kernel's device ms a call
    (device_ms, PROBE_CALLS calls a window) through probes._common's
    launch path, and the host ns a call (stage_ns) of that path, of the
    ctypes call that launches it, and of the ctypes call alone (its
    `launch` 0): the marshalling, then the launch, then the wrapper's own
    share. A checkout without the entry emits nothing."""
    from minialign_tpu_torch import _build
    from minialign_tpu_torch.probes import _common
    if "probe_noop_launch" not in _build._SIGS:
        return
    idx = torch.cuda.current_device()
    fn = _common.entry("probe_noop_launch")
    stream = _common.raw_stream(idx)
    emit(kind="launch_floor", pkg=pkg,
         device_ms=device_ms(torch, lambda: _common.launch_floor(idx),
                             calls=PROBE_CALLS),
         host_ns={
             "loop": stage_ns(torch, lambda: None),
             "ctypes call alone": stage_ns(
                 torch, lambda: fn(0, 0, 0, 0, 0, 0, 0, idx, stream)),
             "ctypes call and launch": stage_ns(
                 torch, lambda: fn(0, 0, 0, 0, 0, 1, 0, idx, stream)),
             "launch_floor": stage_ns(
                 torch, lambda: _common.launch_floor(idx))})
    _build.reset_counts()


def sass_loops(lines):
    """The loops of one function's SASS lines: for each backward branch
    (a BRA to a label or address at or before it), the instructions from
    its target to it: (count, opcode histogram)."""
    ins, labels, jumps = [], {}, []
    for line in lines:
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z]\w*)(.*)", line)
        if not m:
            continue
        ins.append((int(m.group(1), 16), m.group(2)))
        if m.group(2) == "BRA":
            t = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)", m.group(3))
            if t:
                jumps.append((len(ins) - 1, t.group(1) or int(t.group(2), 16)))
    addr = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for at, to in jumps:
        start = labels.get(to) if isinstance(to, str) else addr.get(to)
        if start is not None and start <= at:
            ops = {}
            for _, op in ins[start:at + 1]:
                ops[op] = ops.get(op, 0) + 1
            loops.append((at + 1 - start, dict(sorted(
                ops.items(), key=lambda kv: -kv[1]))))
    return loops


PROBE_SASS = r"binop|roll_concat|step_timer|timing|stream|roll_in_carry|noop"


def sass_counts(pkg, emit, pattern=PROBE_SASS):
    """Emits, for each kernel of the loaded package's library whose name
    matches `pattern` (by default the probe kernels: binop_kernel,
    roll_concat, step_timer, P3's timing loops, P4's stream and roll,
    the launch floor's noop), its SASS instruction count and opcode
    histogram, and those of each loop (sass_loops: a loop's instructions
    over the steps it unrolls are a step's) (cuobjdump -sass; names
    demangled by cu++filt where the toolkit has it)."""
    from minialign_tpu_torch import _build
    bins = [shutil.which(t) or f"/usr/local/cuda/bin/{t}"
            for t in ("cuobjdump", "cu++filt")]
    if not os.path.exists(bins[0]):
        emit(kind="sass", pkg=pkg, error="no cuobjdump")
        return
    text = subprocess.run([bins[0], "-sass", _build.LIB], capture_output=True,
                          text=True, timeout=300).stdout
    funcs, body, cur = {}, {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if re.search(pattern, m.group(1)) else None
            if cur:
                funcs[cur], body[cur] = {}, []
            continue
        if cur:
            body[cur].append(line)
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                     line)
        if cur and m:
            funcs[cur][m.group(1)] = funcs[cur].get(m.group(1), 0) + 1
    names = list(funcs)
    if names and os.path.exists(bins[1]):
        r = subprocess.run([bins[1]], input="\n".join(names),
                           capture_output=True, text=True, timeout=60)
        names = r.stdout.splitlines() or names
    for name, (fn, ops) in zip(names, funcs.items()):
        emit(kind="sass", pkg=pkg, function=name, n=sum(ops.values()),
             ops=dict(sorted(ops.items(), key=lambda kv: -kv[1])),
             loops=[dict(n=n, ops=o) for n, o in sass_loops(body[fn])])


def sketch_bench(torch, pkg, emit):
    """Emits S1's device time (device_ms: SKETCH_CALLS launches a window
    behind a device spin, the median of three windows) at k = 15 on the
    E2E genome (5 Mb) at w = 10 and on a 250 Mb genome (numpy, seed 12,
    as chip_smoke.py's phase 11) at each w of SKETCH_BENCH_W, each result
    held to sketch_device_plain, beside the bytes' bound (a code read, 10
    bytes written a position); then the kernel's registers and SASS (its
    loops: instructions a position)."""
    from minialign_tpu_torch import _build
    from minialign_tpu_torch.index import cuda_sketch
    from minialign_tpu_torch.index import sketch_device as sd
    from minialign_tpu_torch.io import bseq
    from minialign_tpu_torch.probes._common import HBM_BYTES_PER_S
    dev = torch.device("cuda", torch.cuda.current_device())
    k = 15
    e2e = next(iter(bseq.read_seqs(e2e_workload()[0]))).codes
    genomes = [("E2E genome", e2e, (10,)),
               ("250 Mb genome", np.random.default_rng(12).integers(
                   0, 4, 250_000_000, dtype=np.int8), SKETCH_BENCH_W)]
    for name, codes, ws in genomes:
        n = len(codes) - k + 1
        t = torch.from_numpy(np.ascontiguousarray(codes, np.int8)).to(dev)
        for w in ws:
            got = cuda_sketch.sketch_cuda(t, k, w)
            equal = all(map(torch.equal, got,
                            sd.sketch_device_plain(t, k, w)))
            del got
            torch.cuda.empty_cache()
            ms = device_ms(torch, lambda: cuda_sketch.sketch_cuda(t, k, w),
                           calls=SKETCH_CALLS[name])
            nbytes = len(codes) + 10 * n
            emit(kind="sketch", pkg=pkg, genome=name, k=k, w=w,
                 positions=n, equal=equal, device_ms=ms,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 g_positions_s=n / ms / 1e6)
        del t
        torch.cuda.empty_cache()
    emit(kind="registers", pkg=pkg,
         registers=library_registers(_build.LIB, "sketch"))
    sass_counts(pkg, emit, r"sketch")


def card():
    """nvidia-smi's name and power limit of the card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi gave nothing"


def library_registers(lib, pattern):
    """{kernel (mangled): registers a thread} of the kernels of the built
    library `lib` whose name matches `pattern`, from cuobjdump
    --dump-resource-usage (so a library built by an earlier process is
    read too); {"error": ...} without cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {"error": "no cuobjdump"}
    r = subprocess.run([exe, "--dump-resource-usage", lib],
                       capture_output=True, text=True, timeout=300)
    out, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            fn = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        m = re.search(r"\bREG:(\d+)", line)
        if m and fn:
            out[fn] = int(m.group(1))
            fn = None
    return out or {"error": r.stderr[-500:] or "no kernel matched"}


def kernels(torch, pkg, batches, reps, emit):
    from minialign_tpu_torch import _build
    from minialign_tpu_torch.dp import band, cuda_fill, dtrace
    dev = torch.device("cuda")
    p = combined_scores(band.ScoreParams)
    ab, alen, bb, blen = pairs(band, 7, max(batches), 20000)
    for B in batches:
        args = [torch.from_numpy(x[:B]).to(dev)
                for x in (ab, alen, bb, blen)]
        nb = band.max_blocks_for(alen[:B], blen[:B])
        fill = lambda tr: cuda_fill.fill_cuda(p, 64, nb, tr, *args)  # noqa
        timed(torch, lambda: fill(True))                # warm-up, build
        (res, bufs), ms_t = timed(torch, lambda: fill(True), reps, CALLS)
        _, ms_u = timed(torch, lambda: fill(False), reps, CALLS)
        walk = (bufs.masks, bufs.dirs, bufs.iheads, res.max_score,
                res.max_i, res.max_j)
        (_, summ), ms_w = timed(torch, lambda: dtrace.dtrace(p, 64, *walk),
                                reps, CALLS)
        steps = res.n_steps.cpu().numpy()
        moves = summ[0].cpu().numpy()
        cells = int(steps.sum()) * 64
        emit(kind="kernels", pkg=pkg, B=B, fill_trace_ms=ms_t,
             fill_ms=ms_u, walk_ms=ms_w, max_steps=int(steps.max()),
             cells=cells, gcups_trace=cells / ms_t / 1e6,
             gcups=cells / ms_u / 1e6,
             ns_per_step_trace=ms_t * 1e6 / int(steps.max()),
             ns_per_step=ms_u * 1e6 / int(steps.max()),
             max_moves=int(moves.max()), moves=int(moves.sum()),
             ns_per_move=ms_w * 1e6 / max(int(moves.max()), 1))
    emit(kind="registers", pkg=pkg, lib=_build.LIB,
         **library_registers(_build.LIB, "fill_kernel"))


def fused_case(torch, ab, alen, bb, blen, La=None, Lb=None):
    """One fill batch on the card both ways: (rows-mode arguments (a,
    alen, b, blen), store-mode arguments (store_a, store_b, desc, B, La,
    Lb)) from padded rows, widened to La / Lb columns (NCODE) where
    given; the stores padded for the gather (cuda_gather.pad_store), so
    that the two-launch composition runs on them too."""
    from minialign_tpu_torch.dp import band, cuda_gather
    La, Lb = max(La or 0, ab.shape[1]), max(Lb or 0, bb.shape[1])
    ab = np.pad(ab, ((0, 0), (0, La - ab.shape[1])),
                constant_values=band.NCODE)
    bb = np.pad(bb, ((0, 0), (0, Lb - bb.shape[1])),
                constant_values=band.NCODE)
    fa, fb, desc = store_case(ab, alen, bb, blen)
    dev = torch.device("cuda")
    rows = [torch.from_numpy(x).to(dev) for x in (ab, alen, bb, blen)]
    st = [torch.from_numpy(cuda_gather.pad_store(f)).to(dev)
          for f in (fa, fb)]
    return rows, (*st, torch.from_numpy(desc).to(dev), len(alen), La, Lb)


def fused_times(torch, p, W, case, trace, reps=3, calls=CALLS):
    """D2 on one fused_case both ways, results held equal word for word:
    {rows_ms, store_ms}, the rows-mode and the store-mode fill in turns
    (rows, store, store, rows; each the median of `reps` windows of
    `calls` calls between CUDA events), their ns/step over the longest
    problem, and {two_launch_ms, one_launch_ms}, D2 before (gather_pair,
    then the rows-mode fill) and after (the store-mode fill) as device
    time (device_ms, `calls` calls a window)."""
    from minialign_tpu_torch.dp import band, cuda_fill, cuda_gather
    rows, (sa, sb, desc, B, La, Lb) = case
    nb = band.max_blocks_for(rows[1].cpu().numpy(), rows[3].cpu().numpy())

    def by_rows():
        return cuda_fill.fill_cuda(p, W, nb, trace, *rows)

    def by_store():             # store_case's rows are linear
        return band.fill_store(p, W, nb, trace, sa, sb, desc, B, La, Lb,
                               general=False)

    def two_launch():
        a, b = cuda_gather.gather_pair(sa, sb, desc, B, La, Lb)
        e = cuda_gather.desc_fields(desc)["elen"]
        return cuda_fill.fill_cuda(p, W, nb, trace, a, e[:B], b, e[B:])
    got = [by_rows(), by_store(), two_launch()]
    flat = [[t for part in (g if trace else [g]) for t in part] for g in got]
    if not all(all(map(torch.equal, flat[0], f)) for f in flat[1:]):
        raise RuntimeError(f"fill W={W} trace={trace} B={B}: store mode "
                           f"!= rows mode")
    ms = {"rows": [], "store": []}
    for k in ("rows", "store", "store", "rows"):
        ms[k].append(timed(torch, by_rows if k == "rows" else by_store,
                           reps, calls)[1])
    res = got[0][0] if trace else got[0]
    steps = int(res.n_steps.max())
    out = dict(B=B, La=La, Lb=Lb, W=W, trace=trace, max_steps=steps,
               rows_ms=ms["rows"], store_ms=ms["store"],
               rows_ns_per_step=[t * 1e6 / steps for t in ms["rows"]],
               store_ns_per_step=[t * 1e6 / steps for t in ms["store"]],
               two_launch_ms=device_ms(torch, two_launch, reps, calls),
               one_launch_ms=device_ms(torch, by_store, reps, calls))
    return out, got[1]


def fused_bench(torch, pkg, reps, emit):
    """D2 (fused_times) at B=128 x 20 kb, chip_smoke's phase 3 set with
    the -xpacbio scores, traced and untraced, and at E2E_FUSED (the first
    problems of that set, the rows widened to its lengths) untraced and
    traced."""
    from minialign_tpu_torch.dp import band
    p = combined_scores(band.ScoreParams)
    ab, alen, bb, blen = pairs(band, 7, 128, 20000)
    B, La, Lb = E2E_FUSED
    for case in (fused_case(torch, ab, alen, bb, blen),
                 fused_case(torch, ab[:B], alen[:B], bb[:B], blen[:B],
                            La, Lb)):
        for trace in (False, True):
            emit(kind="fused", pkg=pkg,
                 **fused_times(torch, p, 64, case, trace, reps)[0])


def kernel_label(name):
    """A profiler kernel name as the E2E breakdown reports it: the fill
    by band width, tracing and source (store mode: the fused fill, D2;
    rows mode, or an older commit's two-argument fill), a kernel by its
    name and template arguments, anything else (copies, sets) as it is."""
    m = re.search(r"fill_kernel<(\d+), (true|false)(?:, (\w+))?>", name)
    if m:
        src = "fill (rows)" if m.group(3) in (None, "0") else "fused fill"
        return (f"{src} W={m.group(1)} "
                f"{'traced' if m.group(2) == 'true' else 'untraced'}")
    m = re.search(r"::(\w+(?:<[^>]*>)?)\(", name)
    return m.group(1) if m else name


def device_busy(trace_path):
    """(busy ms, wall ms of the traced window, {kernel: [ms, launches]})
    from a chrome trace: device events are the kernels, copies and
    sets; busy is the union of their intervals. Copies are keyed by
    their event name, which gives direction and host memory kind
    ("Memcpy HtoD (Pinned -> Device)")."""
    with open(trace_path) as f:
        ev = json.load(f)["traceEvents"]
    dev = [e for e in ev if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    span = [e for e in ev if e.get("ph") == "X"]
    t0 = min(e["ts"] for e in span)
    t1 = max(e["ts"] + e["dur"] for e in span)
    busy, end = 0.0, -1.0
    for e in sorted(dev, key=lambda e: e["ts"]):
        s, f = e["ts"], e["ts"] + e["dur"]
        if f > end:
            busy += f - max(s, end)
            end = f
    per = {}
    for e in dev:
        k = e["cat"] if e["cat"] == "gpu_memset" else e["name"]
        per.setdefault(k, [0.0, 0])
        per[k][0] += e["dur"] / 1e3
        per[k][1] += 1
    return busy / 1e3, (t1 - t0) / 1e3, per


def profiled(torch, fn):
    """device_busy of one call of fn() under torch.profiler (CPU and
    CUDA activities)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return device_busy(path)


def h2d(per):
    """Host-to-device copies of a device_busy table: (all, pageable)."""
    n = {k: v[1] for k, v in per.items() if "HtoD" in k}
    return sum(n.values()), sum(v for k, v in n.items() if "Pageable" in k)


def e2e_workload():
    """bench_e2e.make_workload's 100 x 20 kb reads on a 5 Mb genome
    (made once, cached under build/e2e): (ref_fa, reads_fq, bases)."""
    os.environ.update(BENCH_E2E_GENOME_MB="5", BENCH_E2E_READS=str(E2E_READS),
                      BENCH_E2E_READLEN="20000")
    sys.path.insert(0, HERE)
    import bench_e2e
    bench_e2e.CACHE = os.path.join(HERE, "minialign_tpu_torch", "build",
                                   "e2e")
    ref_fa, reads_fq, _ = bench_e2e.make_workload()
    with open(reads_fq) as f:
        nbases = sum(len(line.rstrip()) for i, line in enumerate(f)
                     if i % 4 == 1)
    return ref_fa, reads_fq, nbases


def walls(root, pkg, spec, reps, emit):
    """The CLI of the checkout at `root` as a process on the E2E
    workload with -xpacbio -1262144 -v2 (about 12 reads a batch, as
    chip_smoke.py's phase 9c), wall from spawn to exit, `reps` times
    after one untimed run that builds the kernels: for each item of
    `spec`, "tN" runs -tN and "pN" runs -t1 with
    MINIALIGN_PROC_WORKERS=N. Also the output's digest without @PG and
    the merge's remaps (its -v2 log line)."""
    import hashlib
    ref_fa, reads_fq, nbases = e2e_workload()

    def cli(item):
        n = item[1:]
        env = dict(os.environ, MINIALIGN_TORCH_DEVICE="cuda")
        env.pop("MINIALIGN_PROC_WORKERS", None)
        if item[0] == "p":
            env["MINIALIGN_PROC_WORKERS"] = n
        argv = [f"-t{n if item[0] == 't' else 1}", "-xpacbio", "-1262144",
                "-v2", ref_fa, reads_fq]
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "minialign_tpu_torch"]
                           + argv, cwd=root, env=env, capture_output=True,
                           text=True, timeout=600)
        wall = time.time() - t0
        if r.returncode != 0:
            raise RuntimeError(f"{item}: CLI exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        body = "".join(x for x in r.stdout.splitlines(keepends=True)
                       if not x.startswith("@PG"))
        rem = re.findall(r"\((\d+) batch\(es\) remapped", r.stderr)
        return (wall, hashlib.sha256(body.encode()).hexdigest(),
                int(rem[-1]) if rem else None)

    cli("t1")
    for item in spec:
        got = [cli(item) for _ in range(reps)]
        emit(kind="walls", pkg=pkg, item=item, bases=nbases,
             cores=os.cpu_count(), walls_s=[g[0] for g in got],
             sha256_no_pg=sorted({g[1] for g in got}),
             remaps=[g[2] for g in got])


SPLIT_MERGE = """
import json, os, sys, time
t0 = time.time()
from minialign_tpu_torch.parallel import distributed as d
t1 = time.time()
argv, outs = json.loads(sys.argv[1]), json.loads(sys.argv[2])
setup = d.merge_setup(argv)
t2 = time.time()
with open(os.devnull, "w") as f:
    n = d.merge_host_outputs(argv, outs, f, setup)
print(json.dumps([t1 - t0, t2 - t1, time.time() - t2, n]))
"""


def wall_split(ns, emit):
    """The walls of --walls' pN items cut into what a -tN run does, each
    step in processes of its own on the card, one after another: the
    parent's start (the interpreter, the CLI's imports, _prebuild); the
    N hostworker processes started together, with each one's exit time
    and its mapping wall (its .stats); and the merge in a process of its
    own (imports, merge_setup, then merge_host_outputs with it)."""
    ref_fa, reads_fq, _ = e2e_workload()
    argv = ["-t1", "-xpacbio", "-1262144", "-v2", ref_fa, reads_fq]
    env = dict(os.environ, MINIALIGN_TORCH_DEVICE="cuda")
    env.pop("MINIALIGN_PROC_WORKERS", None)

    def py(*args):
        t0 = time.time()
        r = subprocess.run([sys.executable] + list(args), cwd=HERE,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"{args[:2]}: exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        return time.time() - t0, r.stdout

    start, _ = py("-c", "from minialign_tpu_torch import cli; "
                  "cli._prebuild()")
    for n in ns:
        with tempfile.TemporaryDirectory() as td:
            outs = [os.path.join(td, f"w{h}.out") for h in range(n)]
            t0 = time.time()
            procs = [subprocess.Popen(
                [sys.executable, "-m",
                 "minialign_tpu_torch.parallel.hostworker", str(h), str(n),
                 outs[h]] + argv, cwd=HERE, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                for h in range(n)]
            ends = [None] * n
            while any(e is None for e in ends):
                for h, p in enumerate(procs):
                    if ends[h] is None and p.poll() is not None:
                        if p.returncode != 0:
                            raise RuntimeError(f"worker {h} exited "
                                               f"{p.returncode}")
                        ends[h] = time.time() - t0
                time.sleep(0.005)
            maps = []
            for o in outs:
                with open(o + ".stats") as f:
                    maps.append(json.load(f)["wall_map_s"])
            wall, out = py("-c", SPLIT_MERGE, json.dumps(argv),
                           json.dumps(outs))
            imp, setup, merge, remaps = json.loads(out)
        emit(kind="wall_split", workers=n, cores=os.cpu_count(),
             parent_start_s=start, worker_exit_s=ends,
             worker_map_s=maps, merge_process_s=wall, merge_import_s=imp,
             merge_setup_s=setup, merge_s=merge, remaps=remaps)


def e2e(torch, pkg, emit, duo="1"):
    """Maps the E2E workload with MINIALIGN_DUO=duo: a warm-up, three
    timed maps, then one under torch.profiler that also counts, per
    FillEngine.run call (in the calling thread: align_batch's scheduler
    threads share the engine), its fill launches and its requests by
    kind, and the duo requests whose down failed (score 0: their up
    windows are empty), and reads the device's peak memory."""
    from minialign_tpu_torch import _build, cli, extend, native
    os.environ.update(MINIALIGN_TORCH_DEVICE="cuda", MINIALIGN_DUO=duo)
    ref_fa, reads_fq, nbases = e2e_workload()

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-t1", "-xpacbio", ref_fa, reads_fq])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"CLI exited {rc}")
        return out.getvalue()

    t0 = time.time()
    run()
    first = time.time() - t0
    walls = []
    for _ in range(3):
        t0 = time.time()
        run()
        walls.append(time.time() - t0)
    runs, kinds, failed = [], {}, [0]
    # the engine's fill: fill_store, or an older commit's fill on rows
    fill_name = "fill_store" if hasattr(extend, "fill_store") else "fill"
    engine_run = extend.FillEngine.run
    engine_fill = getattr(extend, fill_name)
    mine = threading.local()
    lock = threading.Lock()

    def counted_fill(*args, **kw):
        mine.n += 1
        return engine_fill(*args, **kw)

    def counted_run(self, reqs):
        mine.n = 0
        out = engine_run(self, reqs)
        with lock:
            runs.append(mine.n)
            for r, o in zip(reqs, out):
                kinds[r[0]] = kinds.get(r[0], 0) + 1
                failed[0] += r[0] == "duo" and o[0] == 0
        return out

    _build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    extend.FillEngine.run = counted_run
    setattr(extend, fill_name, counted_fill)
    try:
        busy, wall, per = profiled(torch, run)
    finally:
        extend.FillEngine.run = engine_run
        setattr(extend, fill_name, engine_fill)
    breakdown = {}
    for k, (ms, n) in per.items():
        b = breakdown.setdefault(kernel_label(k), [0.0, 0])
        b[0] += ms
        b[1] += n
    batches = sorted(getattr(_build, "TRACED_FILL_B", []))
    n_h2d, n_pageable = h2d(per)
    emit(kind="e2e", pkg=pkg, duo=duo, bases=nbases, first_s=first,
         walls_s=walls, mbases_per_s=[nbases / w / 1e6 for w in walls],
         profiled_wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
         launches=dict(_build.LAUNCHES), traced_fill_batches=batches,
         traced_fill_batch_median=(batches[len(batches) // 2]
                                   if batches else None),
         engine_runs=len(runs), fill_launches_per_engine_run=runs,
         requests=kinds, duo_failed_downs=failed[0],
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20,
         host_library=native.available(),
         h2d_copies=n_h2d, h2d_pageable=n_pageable,
         breakdown_ms={k: round(v[0], 3) for k, v in breakdown.items()},
         breakdown_launches={k: v[1] for k, v in breakdown.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--batches", default="128,8")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--duo", default="1,0",
                    help="MINIALIGN_DUO settings of the --e2e maps, in order")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--fused", action="store_true",
                    help="D2: the fill in store mode against rows mode "
                    "and the two-launch composition")
    ap.add_argument("--lookup", action="store_true")
    ap.add_argument("--sketch", action="store_true",
                    help="S1 at 5 Mb and 250 Mb, its registers and SASS")
    ap.add_argument("--steps", action="store_true",
                    help="P2's step timer alone, with its SASS")
    ap.add_argument("--walls", default="",
                    help="CLI walls on the E2E workload: comma-separated "
                    "tN (-tN) and pN (MINIALIGN_PROC_WORKERS=N) items")
    ap.add_argument("--wall-reps", type=int, default=2)
    ap.add_argument("--wall-split", default="",
                    help="worker counts N whose -tN run is timed step by "
                    "step (this checkout only)")
    o = ap.parse_args(argv)
    root = os.path.abspath(o.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kbench: no CUDA device", file=sys.stderr)
        return 1
    pkg = os.path.relpath(root, HERE) if root != HERE else "."
    name = card()

    def emit(**kw):
        print(json.dumps(dict(kw, card=name)), flush=True)

    if o.walls:
        walls(root, pkg, o.walls.split(","), o.wall_reps, emit)
    if o.wall_split:
        wall_split([int(x) for x in o.wall_split.split(",")], emit)
    if o.lookup:
        lookup_bench(torch, pkg, emit)
    if o.sketch:
        sketch_bench(torch, pkg, emit)
    if o.steps:
        step_bench(torch, pkg, emit)
        sass_counts(pkg, emit, r"step_timer")
    if o.sketch or o.steps:
        return 0
    gather_bench(torch, pkg, E2E_GATHER, emit)
    batches = [int(x) for x in o.batches.split(",") if x]
    if batches:
        kernels(torch, pkg, batches, o.reps, emit)
    if o.fused:
        fused_bench(torch, pkg, o.reps, emit)
    if o.e2e:
        for duo in o.duo.split(","):
            e2e(torch, pkg, emit, duo)
    if o.probes:
        probes_bench(torch, pkg, emit)
        wrapper_stages(torch, pkg, emit)
        launch_floor(torch, pkg, emit)
        step_bench(torch, pkg, emit)
        loop_bench(torch, pkg, emit)
        sass_counts(pkg, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
