#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minialign_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  0  the card's name and power limit (nvidia-smi); CUDA must be present
  1  build the kernels from csrc/ with nvcc (sm_90a)
  2  K2 gather kernel == its plain version, byte for byte: both sides
     of a batch in one launch on every edge case of
     kbench.GATHER_KINDS (L 128/4096/32768, B 1/3/64 a side, padded and
     unpadded stores), then 512 windows of 32 kb from a 10 MB store,
     timed as device time and as the wrapper's time a call
  3  K1 fill kernel == fill_plain (both score models x W 16/32/64 x
     trace on/off at B=128, ~1 kb; the edge cases of edge_pairs at W 16
     and 64; a max in the last block; W=64 with the -xpacbio scores at
     B=128 x 20 kb), with times, ns/step and the bound
  4  K3 traceback kernel == dtrace_plain on phase 3's trace buffers,
     with ns/move at 20 kb
  4b D1 duo window kernel == duo_window_plain, word for word, on
     kbench.duo_geometry's edge cases at B 1/48/512, the geometry read
     from behind a down descriptor block as the engine uploads it
  5  every golden of tests/data through the port's CLI on CUDA with the
     duo on (GOLDENS, compared as tests/test_golden_sam.py compares
     them): fill, gather and walk launched, the duo on a linear reference
  6  real size: bench_e2e.make_workload's 5 Mb genome and 100 x 20 kb
     reads mapped with -t1 -xpacbio, with MINIALIGN_DUO=1 (the default)
     and then 0 (the two-step path); each SAM (without @PG) must hash to
     the JAX package's digest below; the duo launched in the first run
     and not in the second; the port's host library loaded; the problems
     of each traced fill launch. Then phases 3-4 again at the median of
     those launch sizes (20 kb): the kernels timed, their results held
     to phase 3's plain ones for the same problems. The gather launches
     once a fill launch; a profiled rerun counts the host-to-device
     copies (pageable and pinned); phase 2's timing again at the run's
     median gather launch, phase 4b's at its median duo launch
  7  the step-mix probes P1-P4 through their entry point
     (minialign_tpu_torch.probes.run, i.e. python -m
     minialign_tpu_torch.probes): every case of the four JAX tools, each
     kernel exactly equal to its plain twin (loops at 64 and 2048 steps),
     timed as device time and as a call's host time beside its one
     PyTorch call, ns/step at the tools' own counts (the step timer also
     at 2^17 steps); then P1 and P2 on kbench's edge inputs (the types'
     ends, an odd size, misaligned views), and the step timer at B=128
     and 1024, int16 also from inputs whose adds wrap
  9  the parallel paths (minialign_tpu_torch.parallel): (a) the D3
     lookup kernel == lookup_plain word for word on kbench.LOOKUP_KINDS
     at 1, 2 and 8 shards, then timed (device time, the wrapper's time,
     the plain version, torch.searchsorted on the same table) for the
     median E2E read's hashes against the E2E index split 2 ways (the
     main path's shape: seeding looks up a read a call; the kernels line
     reports it), for every E2E read's hashes in one launch and for 10^5
     queries against 10^7 keys split 2 ways; (b) ShardedIndex.lookup ==
     MMIndex.lookup on those hashes, and align_batch_sharded over
     [cuda:0, cuda:0] with the native seeding off == align_batch on one
     engine, record for record (the lookup's launches counted there);
     (c) the E2E workload with -t1 -xpacbio -1262144 -v2 through the CLI
     in one process, then with MINIALIGN_PROC_WORKERS=2 and 4: the three
     outputs equal byte for byte, each (without @PG) the JAX digest, the
     remaps and every process's launches counted (MINIALIGN_LAUNCH_LOG),
     the walls printed with the host's core count; (d) two dist_host
     processes joined at 127.0.0.1, both on cuda:0, merged == (c)'s
     one-process output
  8  neither jax nor minialign_tpu imported; the kernels' JSON line,
     then the result line

The port never imports JAX; the digests below were taken with the JAX
package on a CPU.
"""

import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")

# Phase 6 workload and its reference digest: SHA-256 of the SAM lines
# other than @PG printed by the JAX package on a CPU for
#   BENCH_E2E_GENOME_MB=5 BENCH_E2E_READS=100 BENCH_E2E_READLEN=20000
#   (bench_e2e.make_workload: seed 42, ~12% PBSIM-profile error)
#   python -m minialign_tpu.cli -t1 -xpacbio ref_g5.0_r100_l20000.fa \
#       reads_g5.0_r100_l20000.fq
# (30.3 s on an 8-core x86-64 CPU; 100 SAM records after @HD and @SQ).
# The same command with -1262144 (batches of 262,144 bases, so that
# worker processes split the reads) gives the same digest (45.1 s).
E2E_READS = 100
E2E_BATCH = "-1262144"
E2E_SHA256 = ("ac52c9b48c971877583630a173e387fc"
              "189fb403037d3baf904dcfbdfb91832a")
# Every golden of tests/data through the port's CLI, as
# tests/test_golden_sam.py runs and compares them: (name, arguments, golden
# file, comparison, SHA-256 of the JAX package's own output without @PG or
# None, arguments of a run that must come first or None). "{d}" stands
# for tests/data and "{t}" for a scratch directory. Comparisons: "exact"
# (the whole text), "pg" (lines other than @PG), "md" (and without MD
# fields), "md_rev" (without the MD field of reverse-strand records, where
# the reference binary's MD is wrong, PARITY.md item 1). The three JAX
# digests were taken with the JAX package on a CPU.
GOLDENS = (
    ("out", ["-t1", "{d}/tref.fa", "{d}/treads.fq"], "ref_out.sam", "pg",
     "8e3128188f38530feac41f4f692962be4a3c4a857d436ec023b8621b9ffcc56a",
     None),
    ("t4", ["-t4", "{d}/tref.fa", "{d}/treads.fq"], "ref_out.sam", "pg",
     None, None),
    ("pacbio", ["-t1", "-xpacbio", "{d}/tref.fa", "{d}/treads.fq"],
     "ref_pacbio.sam", "pg",
     "dfea3e049504c9c36b69dff10e189b8a9d4864666b43028839504c3044fcd80c",
     None),
    ("tags", ["-t1", "-TAS,NM,MD,XS,NH,IH", "{d}/tref.fa", "{d}/treads.fq"],
     "ref_tags.sam", "md_rev",
     "ca8ef1579be1513f83b3c0696b704309d3513be8c2f340ecca97bbbc2b3d2b84",
     None),
    ("qual", ["-t1", "-Q", "{d}/tref.fa", "{d}/treads.fq"], "ref_qual.sam",
     "pg", None, None),
    ("paf", ["-t1", "-Opaf", "{d}/tref.fa", "{d}/treads.fq"], "ref_out.paf",
     "exact", None, None),
    ("maf", ["-t1", "-Omaf", "{d}/tref.fa", "{d}/treads.fq"], "ref_out.maf",
     "exact", None, None),
    ("blast6", ["-t1", "-Oblast6", "{d}/tref.fa", "{d}/treads.fq"],
     "ref_out.b6", "exact", None, None),
    ("ava_paf", ["-t1", "-X", "-xava", "-Opaf", "{d}/treads.fa",
                 "{d}/treads2.fq"], "ref_ava.paf", "exact", None, None),
    ("ava_sam", ["-t1", "-X", "-xava", "-R", "@RG\\tID:ava",
                 "{d}/treads.fa", "{d}/treads2.fq"], "ref_ava_rg.sam", "pg",
     None, None),
    ("twoblock", ["-t1", "{t}/two.mai", "{d}/treads.fq"], "ref_twoblock.sam",
     "pg", None, ["-t1", "-d", "{t}/two.mai", "{d}/tref.fa", "{d}/tref.fa"]),
    ("circ", ["-t1", "-cplasmid", "{d}/cplas.fa", "{d}/creads.fq"],
     "ref_circ.sam", "pg", None, None),
    ("circ_paf", ["-t1", "-Opaf", "-cplasmid", "{d}/cplas.fa",
                  "{d}/creads.fq"], "ref_circ.paf", "exact", None, None),
    ("circ_tags", ["-t1", "-cplasmid", "-TAS,NM,MD,SA,XS,NH,IH",
                   "{d}/cplas.fa", "{d}/creads.fq"], "ref_circ_tags.sam",
     "md_rev", None, None),
    ("bam", ["-t1", "{d}/tref.fa", "{d}/treads.bam"], "ref_bam.sam", "pg",
     None, None),
    ("bam_q", ["-t1", "-Q", "{d}/tref.fa", "{d}/treads.bam"],
     "ref_bam_q.sam", "pg", None, None),
    ("ont", ["-t1", "-xont.r9.4.1d", "{d}/tref.fa", "{d}/treads.fq"],
     "ref_ont.sam", "pg", None, None),
    ("emod", ["-t1", "-a2", "-b5", "-p5", "-q1", "-r3,3", "-eGA+3",
              "{d}/tref.fa", "{d}/treads.fq"], "ref_emod.sam", "pg", None,
     None),
    ("ont1dsq_circ", ["-t1", "-xont.1dsq", "-cplasmid", "-TSA,MD",
                      "{d}/cplas.fa", "{d}/creads.fq"],
     "ref_ont1dsq_circ.sam", "md", None, None),
    ("multi", ["-t1", "{d}/mref.fa", "{d}/mreads.fq"], "ref_multi.sam", "pg",
     None, None),
    ("rep", ["-t1", "-xpacbio", "{d}/repref.fa", "{d}/repreads.fq"],
     "ref_rep.sam", "pg", None, None),
    ("tie", ["-t1", "-xpacbio.ccs", "{d}/tieref.fa", "{d}/tiereads.fq"],
     "ref_tie.sam", "pg", None, None),
    ("xdrop", ["-t1", "-a2", "-b1", "-p4", "-q2", "-TAS,NM,XS,NH",
               "{d}/xdref.fa", "{d}/xdreads.fq"], "ref_xdrop.sam", "md",
     None, None),
    ("circmaf", ["-t1", "-a3", "-b4", "-p0", "-q2", "-m0.5", "-cc0", "-Omaf",
                 "{d}/cmref.fa", "{d}/cmreads.fq"], "ref_circmaf.maf",
     "exact", None, None),
    ("circsplit", ["-t1", "-a3", "-b4", "-p0", "-q2", "-m0.5", "-cc0",
                   "{d}/cmref.fa", "{d}/cmreads.fq"], "ref_circsplit.sam",
     "pg", None, None),
    ("ksort", ["-t1", "-a3", "-b2", "-p5", "-q2", "-r3,3", "-s59", "-m0.2",
               "-k10", "-w3", "{d}/ksref.fa", "{d}/ksreads.fq"],
     "ref_ksort.sam", "md", None, None),
)
# the goldens too slow for the plain CPU path (tests/test_torch_golden_*.py
# leave them to the card)
CARD_GOLDENS = ("ava_paf", "ava_sam", "twoblock", "rep", "xdrop", "ksort")
KERNELS = {
    "fill": ("minialign_tpu_torch/csrc/fill.cu",
             "minialign_tpu/dp/pallas_fill.py:663"),
    "gather": ("minialign_tpu_torch/csrc/gather.cu",
               "minialign_tpu/dp/pallas_gather.py:83"),
    "dtrace": ("minialign_tpu_torch/csrc/dtrace.cu",
               "minialign_tpu/dp/dtrace.py:66"),
    "duo": ("minialign_tpu_torch/csrc/duo.cu",
            "minialign_tpu/extend.py:675"),
    "lookup": ("minialign_tpu_torch/csrc/lookup.cu",
               "minialign_tpu/parallel/shard.py:95"),
    "p1": ("minialign_tpu_torch/csrc/probe_subint32.cu",
           "tests/tools/probe_subint32.py:15"),
    "p2": ("minialign_tpu_torch/csrc/probe_lowprec.cu",
           "tests/tools/probe_lowprec.py:37"),
    "p3": ("minialign_tpu_torch/csrc/probe_bf16ops.cu",
           "tests/tools/probe_bf16ops.py:32"),
    "p4": ("minialign_tpu_torch/csrc/probe_wordstream.cu",
           "tests/tools/probe_wordstream.py:26"),
}
U64_END = 1 << 64
MAPPER = ("fill", "gather", "dtrace", "duo")  # the CLI's kernels
SHARDED = ("fill", "gather", "dtrace", "lookup")  # the sharded pipeline's
PROBES = ("p1", "p2", "p3", "p4")            # the probes' kernels


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


# operations a band cell costs the fill (the recurrence: 13; with the
# trace code: 30) and a move the walk, counted from csrc/fill.cu and
# csrc/dtrace.cu, for the kernels' bounds
FILL_OPS_CELL = {False: 13, True: 30}
WALK_OPS_MOVE = 20


def edge_pairs(np, rng):
    """Problems the fill's max reduction and the walk's start must get
    right: a tandem repeat against itself (ties everywhere), b == a, an
    unrelated pair that X-drops in its first blocks, problems shorter
    than W, and zero-length ones."""
    unit = rng.integers(0, 4, 7)
    rep = np.tile(unit, 60)
    same = rng.integers(0, 4, 500)
    short = rng.integers(0, 4, 20)
    empty = np.zeros(0, np.int64)
    return [(rep, np.tile(unit, 55)), (rep, rep.copy()),
            (same, same.copy()),
            (rng.integers(0, 4, 600), rng.integers(0, 4, 600)),
            (rng.integers(0, 4, 5), rng.integers(0, 4, 9)),
            (rng.integers(0, 4, 40), rng.integers(0, 4, 30)),
            (short, short.copy()), (empty, rng.integers(0, 4, 50)),
            (empty, empty)]


def show(bd):
    return f"bound {bd['bound_ms']:.6f} ms ({bd['bound_by']})"


def bound(nbytes, ops):
    """{bound_ms, bound_by} for nbytes through HBM and ops 32-bit ops."""
    from minialign_tpu_torch.probes._common import bound_ms
    tb, to = bound_ms(nbytes, ops)
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


def fill_bound(res, alen, blen, W, trace):
    """The fill reads each problem's characters and writes its results
    and, traced, its own blocks of codes, dirs, iheads and rprevs."""
    steps = res.n_steps.long()
    B = len(steps)
    nbytes = int(alen.long().sum() + blen.long().sum()) + 8 * B + 20 * B
    if trace:
        nbytes += int((steps // 32).sum()) * (32 * 16 * 4 + 12)
    return bound(nbytes, int(steps.sum()) * W * FILL_OPS_CELL[trace])


def walk_bound(summ):
    """The walk reads a code word a move and the dir words of the blocks
    it crosses, and writes its entries and summary."""
    B = summ.shape[1]
    s = summ.long()
    moves = int(s[0].sum())
    blocks = int(((s[11] + s[12] - 2).clamp(min=0) // 32 + 1).sum())
    nbytes = 4 * moves + 4 * blocks + 16 * B + int(s[1].sum()) + 56 * B
    return bound(nbytes, WALK_OPS_MOVE * moves)


def sam_digest(text):
    body = "".join(line for line in text.splitlines(keepends=True)
                   if not line.startswith("@PG"))
    return hashlib.sha256(body.encode()).hexdigest(), body


# bytes the duo window moves a problem: the down score, i and j and the
# geometry (two int64, four int32) read, the up descriptor's two rows
# (seven words each) and the down rows written
DUO_BYTES = 12 + 32 + 56 + 12
DUO_OPS = 20


def golden_args(args, data, tmp):
    """A GOLDENS entry's arguments with "{d}" and "{t}" filled in."""
    return [a.replace("{d}", data).replace("{t}", tmp) for a in args]


def golden_view(text, mode):
    """What a GOLDENS comparison holds of a CLI output or a golden: the
    whole text, or its lines without @PG, and without the MD fields that
    `mode` drops."""
    if mode == "exact":
        return text
    out = []
    for line in text.splitlines():
        if line.startswith("@PG"):
            continue
        f = line.split("\t")
        if mode == "md" or (mode == "md_rev" and not line.startswith("@")
                            and int(f[1]) & 0x10):
            f = [x for x in f if not x.startswith("MD:Z:")]
        out.append("\t".join(f))
    return out


def run_cli(cli, args):
    old = sys.stdout
    sys.stdout = buf = io.StringIO()
    try:
        rc = cli.main(args)
    finally:
        sys.stdout = old
    if rc != 0:
        fail(f"CLI {' '.join(args)} exited {rc}")
    return buf.getvalue()


def run_cli_procs(args, nproc, tmp):
    """The port's CLI as a process (with MINIALIGN_PROC_WORKERS=nproc):
    (stdout, stderr, wall s, launches of it and its workers)."""
    logs = tempfile.mkdtemp(dir=tmp)
    env = dict(os.environ, MINIALIGN_TORCH_DEVICE="cuda",
               MINIALIGN_PROC_WORKERS=str(nproc), MINIALIGN_LAUNCH_LOG=logs)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "minialign_tpu_torch"] + args,
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.time() - t0
    if r.returncode != 0:
        fail(f"CLI with {nproc} process(es) exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    from minialign_tpu_torch import _build
    return r.stdout, r.stderr, wall, _build.worker_launches(logs)


def phase9(np, torch, card, stats, ref_fa, reads_fq):
    """The parallel paths; returns the lookup kernel's launches on the
    sharded pipeline's run (9b)."""
    from minialign_tpu_torch import _build, cli, kbench, native
    from minialign_tpu_torch.extend import FillEngine
    from minialign_tpu_torch.index.build import build_index
    from minialign_tpu_torch.index.sketch import sketch
    from minialign_tpu_torch.io import bseq
    from minialign_tpu_torch.params import IndexParams
    from minialign_tpu_torch.parallel import cuda_lookup, distributed, shard
    from minialign_tpu_torch.pipeline import align_batch
    dev = torch.device("cuda", 0)
    lib = _build.library()
    timed = kbench.timed

    # (a) the kernel against its plain version on the edge tables
    t0 = time.time()
    err, n_cases = 0, 0
    for kind in kbench.LOOKUP_KINDS:
        keys, off = kbench.lookup_table(kind, build_index, IndexParams)
        q = kbench.lookup_queries(keys)
        for n in (1, 2, 8):
            t = kbench.lookup_tensors(
                torch, shard.shard_index_arrays(keys, off, n), q, dev)
            got, want = cuda_lookup.lookup(*t), cuda_lookup.lookup_plain(*t)
            err = max([err] + [int((g - w).abs().max()) if g.numel() else 0
                               for g, w in zip(got, want)])
            if not all(map(torch.equal, got, want)):
                fail(f"lookup kernel != lookup_plain: {kind}, {n} shards")
            n_cases += 1
    say(f"[9a] lookup equal to plain, word for word, on {n_cases} cases "
        f"({', '.join(kbench.LOOKUP_KINDS)} at 1/2/8 shards; "
        f"{time.time() - t0:.1f} s)")

    o = cli.Opts()
    cli.parse_argv(o, ["-xpacbio"])
    cli.finalize(o)
    ip, mp = cli.make_params(o)
    ref = list(bseq.read_seqs(ref_fa))
    mi = build_index(ip, [x.name for x in ref], [x.codes for x in ref])
    reads = [x.codes for x in bseq.read_seqs(reads_fq)]
    # seeding looks up one read's hashes a call (chain.collect_seeds):
    # the median read's is the main path's shape
    per_read = sorted((sketch(np.asarray(c, np.int64) & 3, mi.k, mi.w)[0]
                       for c in reads), key=len)
    q_read = np.asarray(per_read[len(per_read) // 2], np.uint64)
    q_e2e = np.concatenate(per_read).astype(np.uint64)
    rng = np.random.default_rng(9)
    big_keys = np.unique(rng.integers(0, U64_END, 10_200_000,
                                      dtype=np.uint64))[:10_000_000]
    rng.shuffle(big_keys)
    big_off = np.concatenate([[0], np.cumsum(rng.integers(
        1, 5, len(big_keys)))]).astype(np.uint32)
    big_q = np.concatenate([rng.choice(big_keys, 50_000),
                            rng.integers(0, U64_END, 50_000,
                                         dtype=np.uint64)])
    res = {}
    for name, keys, off, q in (("read", mi.keys, mi.offsets, q_read),
                               ("e2e", mi.keys, mi.offsets, q_e2e),
                               ("big", big_keys, big_off, big_q)):
        tabs = shard.shard_index_arrays(keys, off, 2)
        kt, st_, ct, qt = kbench.lookup_tensors(torch, tabs, q, dev)
        S, K = kt.shape
        Q = len(q)
        so = torch.empty((S, Q), dtype=torch.int64, device=dev)
        co = torch.empty_like(so)
        stream = _build.stream_of(kt)
        ptrs = (kt.data_ptr(), st_.data_ptr(), ct.data_ptr(), S, K,
                qt.data_ptr(), Q, so.data_ptr(), co.data_ptr(), stream)
        ms = kbench.device_ms(torch, lambda: lib.lookup_launch(*ptrs),
                              calls=20)
        run = lambda: cuda_lookup.lookup(kt, st_, ct, qt)  # noqa: E731
        got = run()
        _, wms = timed(torch, run, 3, 20)
        want, pms = timed(torch, lambda: cuda_lookup.lookup_plain(
            kt, st_, ct, qt), 3)
        if not all(map(torch.equal, got, want)):
            fail(f"lookup kernel != lookup_plain at the {name} size")
        kf = kt ^ cuda_lookup.SIGN
        qf = (qt ^ cuda_lookup.SIGN)[None, :].expand(S, -1).contiguous()
        lms = kbench.device_ms(torch, lambda: torch.searchsorted(kf, qf),
                               calls=20)
        found = int((got[1] > 0).sum())
        nb = kbench.lookup_bytes(tabs[0], q, found)
        bd = bound(nb, kbench.lookup_ops(tabs[0], q))
        res[name] = dict(ms=ms, wrapper_ms=wms, plain_ms=pms,
                         library_ms=lms, bound_bytes=nb, **bd)
        say(f"[9a] lookup {name}: {Q} queries against {len(keys)} keys in "
            f"2 shards of {K} ({found} hits): equal to plain; kernel "
            f"{ms:.5f} ms device time, wrapper {wms:.5f} ms a call, "
            f"torch.searchsorted {lms:.5f} ms device time, plain "
            f"{pms:.3f} ms; {show(bd)}, {nb} bytes on {card}")
        del kt, st_, ct, qt, so, co, kf, qf, got, want
    stats["lookup"].update(max_abs_err=err, **res["read"], e2e=res["e2e"],
                           big=res["big"])
    del big_keys, big_off, big_q

    # (b) the sharded index and pipeline over [cuda:0, cuda:0]
    mesh = [dev, dev]
    t0 = time.time()
    smi = shard.ShardedIndex(mi, mesh)
    if not all(np.array_equal(g, w) for g, w in
               zip(smi.lookup(q_e2e), mi.lookup(q_e2e))):
        fail("ShardedIndex.lookup != MMIndex.lookup on the E2E hashes")
    want = align_batch(mp, mi, reads, FillEngine(mp.score, device=dev))
    lib_, tried = native._lib, native._tried
    native._lib, native._tried = None, True          # the Python seeding
    try:
        _build.reset_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        got = shard.align_batch_sharded(mp, mi, reads, mesh)
        torch.cuda.synchronize()
        swall = time.time() - t1
        n = {k: _build.LAUNCHES[k] for k in SHARDED + ("duo",)}
    finally:
        native._lib, native._tried = lib_, tried
    if got != want:
        fail("align_batch_sharded over [cuda:0, cuda:0] != align_batch")
    if not all(n[k] for k in SHARDED) or n["duo"]:
        fail(f"sharded pipeline: launches {n}")
    say(f"[9b] ShardedIndex.lookup == MMIndex.lookup on {len(q_e2e)} "
        f"hashes; align_batch_sharded over [cuda:0, cuda:0], native "
        f"seeding off: {sum(r is not None for r in got)} of {len(reads)} "
        f"reads mapped, equal to align_batch, record for record "
        f"({swall:.2f} s; launches {n}; {time.time() - t0:.1f} s)")

    # (c) the E2E workload in 1, 2 and 4 processes
    args = ["-t1", "-xpacbio", E2E_BATCH, "-v2", ref_fa, reads_fq]
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for nproc in (1, 2, 4):
            out, errs, wall, w = run_cli_procs(args, nproc, tmp)
            sha, _ = sam_digest(out)
            if sha != E2E_SHA256:
                fail(f"{nproc} process(es): SAM digest {sha} != JAX "
                     f"package's {E2E_SHA256}")
            if not all(w[k] for k in MAPPER):
                fail(f"{nproc} process(es): launches {w}")
            rem = [x for x in errs.splitlines() if "remapped" in x]
            outs[nproc] = out
            say(f"[9c] E2E {' '.join(args[:4])} with {nproc} process(es): "
                f"SAM identical to the JAX package's; wall {wall:.2f} s "
                f"({os.cpu_count()} cores); launches {w}; "
                f"{rem[0].split('] ')[-1] if rem else 'no merge'} on {card}")
        if not outs[1] == outs[2] == outs[4]:
            fail("1, 2 and 4 processes: outputs differ")
        say("[9c] 1, 2 and 4 processes: outputs equal byte for byte, @PG "
            "included")

        # (d) two hosts on one card, merged
        from socket import socket
        with socket() as sk:
            sk.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{sk.getsockname()[1]}"
        hosts = [os.path.join(tmp, f"host{h}.out") for h in range(2)]
        env = dict(os.environ, MINIALIGN_TORCH_DEVICE="cuda")
        t0 = time.time()
        ps = [subprocess.Popen(
            [sys.executable, "-m", "minialign_tpu_torch.parallel.dist_host",
             str(h), "2", coord, hosts[h]] + args, cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            for h in range(2)]
        for p in ps:
            _, e = p.communicate(timeout=600)
            if p.returncode != 0:
                fail(f"dist_host exited {p.returncode}: {e[-2000:]}")
        buf = io.StringIO()
        n_remap = distributed.merge_host_outputs(args, hosts, buf)
        if buf.getvalue() != outs[1]:
            fail("two dist_host processes merged != one process")
        say(f"[9d] two dist_host processes (gloo at {coord}, both on "
            f"cuda:0) merged equal to one process, @PG included "
            f"({n_remap} batch(es) remapped; {time.time() - t0:.1f} s)")
    return n["lookup"]


def main():
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)          # the CLI's worker processes run from here
    try:
        import numpy as np
        import torch

        from minialign_tpu_torch import _build
    except ImportError as e:
        fail(f"minialign_tpu_torch is not importable from {ROOT}: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from minialign_tpu_torch import cli, kbench, native
    from minialign_tpu_torch.dp import (band, cuda_fill, cuda_gather, dtrace,
                                        duo)
    from minialign_tpu_torch.params import MapParams, ScoreParams
    timed = kbench.timed
    dev = torch.device("cuda")
    stats = {k: {} for k in KERNELS}

    # ---- 0: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave nothing"
    say(f"[0] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    # ---- 1: build
    t0 = time.time()
    _build.library()
    say(f"[1] kernels built in {time.time() - t0:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("    " + line.strip())

    # ---- 2: K2 gather: the edge cases, then 512 windows of 32 kb
    t0 = time.time()
    rng = np.random.default_rng(1)
    Ls, n_cases = (128, 4096, 32768), 0
    for i, La in enumerate(Ls):
        Lb = Ls[(i + 1) % len(Ls)]                   # unequal L a side
        for B in (1, 3, 64):
            (fa, sa), (fb, sb) = (kbench.gather_side(rng, x, B)
                                  for x in (La, Lb))
            blk = torch.from_numpy(cuda_gather.pack_desc([sa, sb])).to(dev)
            for pad in (cuda_gather.pad_store, None):
                sta, stb = (torch.from_numpy(pad(f) if pad else f).to(dev)
                            for f in (fa, fb))
                got = cuda_gather.gather_pair(sta, stb, blk, B, La, Lb)
                want = cuda_gather.gather_pair_plain(sta, stb, blk, B, La, Lb)
                if not all(map(torch.equal, got, want)):
                    fail(f"gather kernel != plain: La={La} Lb={Lb} B={B} "
                         f"padded={pad is not None}")
                n_cases += 1
    say(f"[2] gather equal to plain on {n_cases} two-sided batches: every "
        f"edge case ({', '.join(kbench.GATHER_KINDS)}) at L {Ls}, B 1/3/64 "
        f"a side, padded and unpadded stores ({time.time() - t0:.0f} s)")
    flat, side, L = kbench.gather_big()
    B = len(side["base"])
    store = torch.from_numpy(cuda_gather.pad_store(flat)).to(dev)
    ms, wms, (got,) = kbench.gather_times(torch, [store], [side], [L])
    blk = torch.from_numpy(cuda_gather.pack_desc([side])).to(dev)
    (want, _), pms = timed(torch, lambda: cuda_gather.gather_pair_plain(
        store, store, blk, B, L, 0), 3)
    if not torch.equal(got, want):
        fail("gather kernel != gather_pair_plain at B=512 x 32 kb")
    nbytes = B * L + kbench.gather_read_bytes(side, L) + blk.numel() * 4
    stats["gather"].update(max_abs_err=int((got.int() - want.int()).abs()
                                           .max()), ms=ms, plain_ms=pms,
                           library_ms=None, **bound(nbytes, 0))
    say(f"[2] gather B={B} L={L} (one side): equal; kernel {ms:.5f} ms "
        f"device time ({nbytes / ms / 1e6:.1f} GB/s), wrapper {wms:.5f} ms a "
        f"call with the descriptor upload, plain {pms:.3f} ms; "
        f"{show(stats['gather'])} on {card}")
    del got, want, store

    # ---- 3: K1 fill; 4: K3 walk on its trace buffers
    pr = {"affine": MapParams().score,
          "combined": kbench.combined_scores(ScoreParams)}   # -xpacbio's

    def on_dev(xs):
        return [torch.from_numpy(x).to(dev) for x in xs]

    def pairs(seed, B, n):
        return on_dev(kbench.pairs(band, seed, B, n))

    err = {"fill": 0, "dtrace": 0}

    def same_fill(W, trace, got, want, rows=None):
        """The kernel's results equal the plain ones (for the first
        `rows` problems of `want`: no batch-wide n_blocks then), trace
        words over each problem's own blocks."""
        rk, rp = (got[0], want[0]) if trace else (got, want)
        n = len(rk.n_steps)
        fields = ("max_score", "max_i", "max_j", "n_steps") + (
            () if rows else ("n_blocks",))
        for f in fields:
            xk, xp = getattr(rk, f), getattr(rp, f)
            d = int((xk - (xp[:n] if rows else xp)).abs().max())
            err["fill"] = max(err["fill"], d)
            if d:
                fail(f"fill W={W} trace={trace}: {f} differs by {d}")
        if trace:
            own = (rk.n_steps // band.BLK).tolist()
            for f in ("masks", "dirs", "iheads", "rprevs"):
                xk, xp = getattr(got[1], f), getattr(want[1], f)
                for k, nk in enumerate(own):
                    if not torch.equal(xk[k, :nk], xp[k, :nk]):
                        fail(f"fill W={W}: trace {f} differs, problem {k}")

    def check_fill(p, W, trace, args, reps=1, nb=None):
        nb = nb or band.max_blocks_for(args[1].cpu().numpy(),
                                       args[3].cpu().numpy())
        run = lambda: cuda_fill.fill_cuda(p, W, nb, trace, *args)  # noqa
        if reps > 1:
            run()                          # warm-up: allocations
        got, ms = timed(torch, run, reps, kbench.CALLS if reps > 1 else 1)
        want, pms = timed(torch, lambda: band.fill_plain(
            p, W, nb, trace, *args))
        same_fill(W, trace, got, want)
        return got, want, ms, pms

    def walk_args(res, bufs):
        return (bufs.masks, bufs.dirs, bufs.iheads, res.max_score,
                res.max_i, res.max_j)

    def check_walk(p, W, res, bufs, reps=1):
        walk = walk_args(res, bufs)
        if reps > 1:
            dtrace.dtrace(p, W, *walk)     # warm-up: allocations
        (rk, sk), ms = timed(torch, lambda: dtrace.dtrace(p, W, *walk),
                             reps, kbench.CALLS if reps > 1 else 1)
        (rp, sp), pms = timed(torch, lambda: dtrace.dtrace_plain(
            p, W, *walk))
        err["dtrace"] = max(err["dtrace"], int((sk - sp).abs().max()))
        if not (torch.equal(sk, sp) and torch.equal(rk, rp)):
            fail(f"dtrace W={W}: kernel != dtrace_plain")
        return (rk, sk), (rp, sp), ms, pms

    t0 = time.time()
    for pname, p in pr.items():
        for W in (16, 32, 64):
            args = pairs(W, 128, 2000)
            for trace in (False, True):
                got, _, ms, pms = check_fill(p, W, trace, args)
                if trace:
                    check_walk(p, W, *got)
    say(f"[3/4] fill and walk equal to plain: 2 models x W 16/32/64 x "
        f"trace on/off, B=128, ~2 kb ({time.time() - t0:.0f} s)")

    t0 = time.time()
    rng = np.random.default_rng(5)
    edge = list(zip(*edge_pairs(np, rng)))
    args = on_dev((*band.pad_codes(edge[0]), *band.pad_codes(edge[1])))
    for pname, p in pr.items():
        for W in (16, 64):
            for trace in (False, True):
                got, _, _, _ = check_fill(p, W, trace, args)
                if trace:
                    check_walk(p, W, *got)
    # a == b with the block budget ending in the block of the max
    x = rng.integers(0, 4, 700)
    args = on_dev((*band.pad_codes([x]), *band.pad_codes([x])))
    nb = (2 * len(x) - 2) // band.BLK + 1
    for W in (16, 64):
        got, _, _, _ = check_fill(pr["affine"], W, True, args, nb=nb)
        res = got[0]
        pp = int(res.max_i[0] + res.max_j[0]) - 2
        if int(res.max_i[0]) != len(x) or pp // band.BLK != nb - 1 or \
                int(res.n_steps[0]) != nb * band.BLK:
            fail(f"fill W={W}: the max is not in the last block "
                 f"({res.max_i[0]}, {res.max_j[0]}, {res.n_steps[0]})")
        check_walk(pr["affine"], W, *got)
    say(f"[3/4] fill and walk equal to plain on the edge cases (tandem "
        f"repeat, b == a, X-drop at once, shorter than W, empty; 2 models "
        f"x W 16/64 x trace on/off) and on a max in the last block "
        f"({time.time() - t0:.0f} s)")

    p = pr["combined"]
    args20 = pairs(7, 128, 20000)
    got, want20, tms, pms = check_fill(p, 64, True, args20, reps=3)
    # the untraced kernel against the traced plain fill's results (the
    # same FillResult: tracing changes none of it)
    nb20 = band.max_blocks_for(args20[1].cpu().numpy(),
                               args20[3].cpu().numpy())
    fill_u = lambda: cuda_fill.fill_cuda(p, 64, nb20, False, *args20)  # noqa
    fill_u()                                             # warm-up
    got_u, ms = timed(torch, fill_u, 3, kbench.CALLS)
    same_fill(64, False, got_u, want20[0])
    cells = int(got_u.n_steps.sum()) * 64
    mx = int(got_u.n_steps.max())
    say(f"[3] fill W=64 -xpacbio scores B=128 L=20kb trace=False: equal "
        f"to the traced plain fill's results; kernel {ms:.2f} ms "
        f"({cells / ms / 1e6:.1f} GCUPS, {ms * 1e6 / mx:.1f} ns/step over "
        f"{mx} steps); "
        f"{show(fill_bound(got_u, args20[1], args20[3], 64, False))} on "
        f"{card}")
    # D2, the JAX package's fused gather + fill, is the gather then this
    # fill here: its bound is theirs added, at these shapes (the gather
    # reads each row's bases and its descriptor, writes the padded rows)
    B20 = args20[0].shape[0]
    g_bytes = (int(args20[1].long().sum() + args20[3].long().sum())
               + B20 * (args20[0].shape[1] + args20[2].shape[1])
               + 2 * B20 * 4 * cuda_gather.WORDS)
    gb, fb = (bound(g_bytes, 0)["bound_ms"],
              fill_bound(got_u, args20[1], args20[3], 64, False)["bound_ms"])
    say(f"[3] D2 (gather_pair, then the untraced fill) at B=128 x 20 kb: "
        f"bound {gb + fb:.6f} ms = K2's {gb:.6f} + K1's {fb:.6f}")
    del got_u
    res = got[0]
    cells = int(res.n_steps.sum()) * 64
    mx = int(res.n_steps.max())
    stats["fill"].update(ms=tms, plain_ms=pms, library_ms=None,
                         **fill_bound(res, args20[1], args20[3], 64, True))
    say(f"[3] fill W=64 -xpacbio scores B=128 L=20kb trace=True: equal; "
        f"kernel {tms:.2f} ms ({cells / tms / 1e6:.1f} GCUPS, "
        f"{tms * 1e6 / mx:.1f} ns/step over {mx} steps), plain {pms:.1f} "
        f"ms; {show(stats['fill'])} on {card}")
    (rk, sk), plain20, wms, wpms = check_walk(p, 64, *got, reps=3)
    moves = int(sk[0].max())
    bad = int(sk[dtrace.SUMMARY_ROWS.index("bad")].sum())
    stats["dtrace"].update(ms=wms, plain_ms=wpms, library_ms=None,
                           **walk_bound(sk))
    say(f"[4] walk W=64 B=128 L=20kb: equal ({bad} out of band); kernel "
        f"{wms:.2f} ms ({wms * 1e6 / moves:.1f} ns/move over {moves} moves),"
        f" plain {wpms:.1f} ms; {show(stats['dtrace'])} on {card}")
    del got, rk, sk, args

    # ---- 4b: D1 duo window
    t0 = time.time()
    err["duo"] = 0

    def duo_case(B, seed):
        """(kernel call, plain call, summary buffer, down rows, block,
        words before the geometry) on duo_geometry(seed, B), the
        geometry behind a down descriptor block as the engine uploads
        it, the kernel writing the down rows into the summary's last
        three rows."""
        c = kbench.duo_geometry(seed, B)
        g = duo.pack_geom(c["rvbase"], c["qub"], c["rlen"], c["qlen"],
                          c["cp0"], c["cp1"])
        nd = cuda_gather.WORDS * 2 * B
        blk = torch.from_numpy(np.concatenate(
            [np.full(nd, -3, np.int32), g])).to(dev)
        t = [torch.as_tensor(c[k], dtype=torch.int32, device=dev)
             for k in ("score", "mi", "mj")]
        summ = torch.full((17, B), -1, dtype=torch.int32, device=dev)
        return (lambda: duo.duo_window(*t, blk[nd:], out=summ[14:]),
                lambda: duo.duo_window_plain(*t, blk[nd:]), summ, t, blk, nd)

    for B in (1, 48, 512):
        run_k, run_p, summ, *_ = duo_case(B, B)
        desc, _ = run_k()
        want, dsum = run_p()
        err["duo"] = max(err["duo"], int((desc - want).abs().max()),
                         int((summ[14:] - dsum).abs().max()))
        if not (torch.equal(desc, want) and torch.equal(summ[14:], dsum)
                and bool((summ[:14] == -1).all())):
            fail(f"duo window kernel != duo_window_plain at B={B}")
    say(f"[4b] duo window equal to plain at B 1/48/512 (failed downs, "
        f"clipped tp, both caps, cp at 0, bases past 2^31; "
        f"{time.time() - t0:.0f} s)")

    # ---- 5: every golden through the CLI on CUDA, duo on
    os.environ["MINIALIGN_TORCH_DEVICE"] = "cuda"
    t5 = time.time()
    for name, args, golden, mode, jax_sha, pre in GOLDENS:
        with tempfile.TemporaryDirectory() as tmp:
            if pre:
                run_cli(cli, golden_args(pre, DATA, tmp))
            # -tN runs N worker processes: they log their launches here
            logs = os.path.join(tmp, "launches")
            os.mkdir(logs)
            os.environ["MINIALIGN_LAUNCH_LOG"] = logs
            _build.reset_counts()
            t0 = time.time()
            out = run_cli(cli, golden_args(args, DATA, tmp))
            del os.environ["MINIALIGN_LAUNCH_LOG"]
            workers = _build.worker_launches(logs)
        dt = time.time() - t0
        counts = {k: _build.LAUNCHES[k] + workers[k] for k in MAPPER}
        circular = any(a.startswith("-c") for a in args)
        if not all(counts[k] for k in MAPPER if k != "duo" or not circular):
            fail(f"{golden} ({name}): a kernel was not launched: {counts}")
        if jax_sha and sam_digest(out)[0] != jax_sha:
            fail(f"{golden} ({name}): SAM digest {sam_digest(out)[0]} != "
                 f"JAX package's {jax_sha}")
        with open(os.path.join(DATA, golden)) as f:
            want = f.read()
        if golden_view(out, mode) != golden_view(want, mode):
            fail(f"{golden} ({name}): not identical ({mode})")
        say(f"[5] {name}: {golden} identical ({mode}"
            f"{', and to the JAX digest' if jax_sha else ''}; {dt:.1f} s, "
            f"launches {counts})")
    say(f"[5] all {len(GOLDENS)} goldens identical with the duo on "
        f"({time.time() - t5:.0f} s)")

    # ---- 6: real size
    os.environ.update(BENCH_E2E_GENOME_MB="5", BENCH_E2E_READS=str(E2E_READS),
                      BENCH_E2E_READLEN="20000")
    import bench_e2e
    bench_e2e.CACHE = os.path.join(ROOT, "minialign_tpu_torch", "build",
                                   "e2e")
    t0 = time.time()
    ref_fa, reads_fq, _ = bench_e2e.make_workload()
    with open(reads_fq) as f:
        nbases = sum(len(line.rstrip()) for i, line in enumerate(f)
                     if i % 4 == 1)
    say(f"[6] workload: {E2E_READS} reads, {nbases} bases, 5 Mb genome "
        f"({time.time() - t0:.1f} s to write)")
    for env in ("1", "0"):
        os.environ["MINIALIGN_DUO"] = env
        _build.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out = run_cli(cli, ["-t1", "-xpacbio", ref_fa, reads_fq])
        wall = time.time() - t0
        n = {k: _build.LAUNCHES[k] for k in MAPPER}
        sha, body = sam_digest(out)
        if sha != E2E_SHA256:
            fail(f"real-size SAM digest {sha} (MINIALIGN_DUO={env}) != JAX "
                 f"package's {E2E_SHA256}")
        if not all(v for k, v in n.items() if k != "duo") or \
                (n["duo"] > 0) != (env == "1"):
            fail(f"real size, MINIALIGN_DUO={env}: launches {n}")
        if n["gather"] != n["fill"]:
            fail(f"real size: {n['gather']} gather launches for "
                 f"{n['fill']} fill launches")
        if env == "1":
            launches = n
            batches = sorted(_build.TRACED_FILL_B)
            shapes = sorted(_build.GATHER_SHAPES,
                            key=lambda x: (x[0] + x[1], x[2] + x[3]))
        recs = sum(1 for line in body.splitlines()
                   if not line.startswith("@"))
        say(f"[6] real size -t1 -xpacbio, MINIALIGN_DUO={env}: SAM "
            f"identical to the JAX package's ({recs} records); wall "
            f"{wall:.2f} s{' (the first map)' if env == '1' else ''}, "
            f"{nbases / wall / 1e6:.3f} Mbases/s, launches {n}, problems "
            f"per traced fill launch {sorted(_build.TRACED_FILL_B)} on "
            f"{card}")
    del os.environ["MINIALIGN_DUO"]
    if not native.available():
        fail("the port's host library (csrc/host) did not load")
    _build.reset_counts()
    busy, pwall, per = kbench.profiled(torch, lambda: run_cli(
        cli, ["-t1", "-xpacbio", ref_fa, reads_fq]))
    n_h2d, n_page = kbench.h2d(per)
    copies = {k: v[1] for k, v in per.items() if k.startswith("Memcpy")}
    say(f"[6] gather launches {launches['gather']}, one a fill launch; "
        f"profiled rerun: {n_h2d} host-to-device copies, {n_page} from "
        f"pageable memory ({copies}), gather launches "
        f"{_build.LAUNCHES['gather']}, device busy {busy:.1f} of "
        f"{pwall:.1f} ms")

    # ---- 2 again at the E2E run's median gather launch
    Ba, Bb, La, Lb = shapes[len(shapes) // 2]
    stores, sides = [], []
    for Bx, Lx in ((Ba, La), (Bb, Lb)):
        f, sx = kbench.gather_side(rng, Lx, Bx, kinds=("residue",))
        stores.append(torch.from_numpy(cuda_gather.pad_store(f)).to(dev))
        sides.append(sx)
    gms, gwms, _ = kbench.gather_times(torch, stores, sides, [La, Lb])
    say(f"[2] gather at the E2E median launch ({Ba} + {Bb} rows, L {La} / "
        f"{Lb}; median of {len(shapes)} launches): equal to plain; kernel "
        f"{gms:.5f} ms device time, wrapper {gwms:.5f} ms a call on {card}")

    # ---- 4b again at the E2E run's duo launch size (a duo batch's one
    # traced fill: TRACED_FILL_B of the duo run)
    if not batches:
        fail("real size: no traced fill launch")
    Bd = batches[len(batches) // 2]
    run_k, run_p, summ, (sc, mi_, mj_), blk, nd = duo_case(Bd, 99)
    lib = _build.library()
    desc = torch.empty(cuda_gather.WORDS * 2 * Bd, dtype=torch.int32,
                       device=dev)
    stream = _build.stream_of(blk)
    dargs = (sc.data_ptr(), mi_.data_ptr(), mj_.data_ptr(),
             blk[nd:].data_ptr(), Bd, desc.data_ptr(), summ[14:].data_ptr(),
             Bd, stream)
    dms = kbench.device_ms(torch, lambda: lib.duo_window_launch(*dargs))
    run_k()                                      # warm-up: allocations
    _, dwms = timed(torch, run_k, 3, kbench.WRAP_CALLS)
    (want, dsum), dpms = timed(torch, run_p, 3)
    if not (torch.equal(desc, want) and torch.equal(summ[14:], dsum)):
        fail(f"duo window kernel != duo_window_plain at B={Bd}")
    stats["duo"].update(max_abs_err=err["duo"], ms=dms, plain_ms=dpms,
                        library_ms=None,
                        **bound(DUO_BYTES * Bd, DUO_OPS * Bd))
    say(f"[4b] duo window at the E2E median duo launch (B={Bd}): equal to "
        f"plain; kernel {dms:.5f} ms device time, wrapper {dwms:.5f} ms a "
        f"call, plain {dpms:.4f} ms; {show(stats['duo'])} on {card}")

    # ---- 3/4 again at the E2E run's launch size
    Bs = Bd
    sub20 = [x[:Bs] for x in args20]
    nb = band.max_blocks_for(sub20[1].cpu().numpy(), sub20[3].cpu().numpy())
    fill_s = lambda: cuda_fill.fill_cuda(p, 64, nb, True, *sub20)  # noqa
    timed(torch, fill_s)                                     # warm-up
    got, ms = timed(torch, fill_s, 3, kbench.CALLS)
    same_fill(64, True, got, want20, rows=Bs)
    res = got[0]
    mx = int(res.n_steps.max())
    cells = int(res.n_steps.sum()) * 64
    (rk, sk), wms = timed(torch, lambda: dtrace.dtrace(
        p, 64, *walk_args(*got)), 3, kbench.CALLS)
    rp, sp = plain20
    if not (torch.equal(sk[:13], sp[:13, :Bs]) and
            torch.equal(rk, rp[:Bs, :rk.shape[1]])):
        fail(f"dtrace W=64 B={Bs}: kernel != dtrace_plain's rows")
    moves = int(sk[0].max())
    say(f"[3/4] at the E2E launch size B={Bs} (median of {len(batches)} "
        f"traced launches), W=64 L=20kb, equal to the plain rows: fill "
        f"trace=True {ms:.2f} ms ({cells / ms / 1e6:.1f} GCUPS, "
        f"{ms * 1e6 / mx:.1f} ns/step over {mx} steps; "
        f"{show(fill_bound(res, sub20[1], sub20[3], 64, True))}), walk "
        f"{wms:.2f} ms ({wms * 1e6 / moves:.1f} ns/move over {moves} moves;"
        f" {show(walk_bound(sk))}) on {card}")
    stats["fill"]["max_abs_err"] = err["fill"]
    stats["dtrace"]["max_abs_err"] = err["dtrace"]
    del got, rk, sk, want20, plain20, args20

    # ---- 7: the probes' entry point, then the step timer at B=1024
    from minialign_tpu_torch import probes
    from minialign_tpu_torch.probes import lowprec, subint32
    say("[7] probes P1-P4: python -m minialign_tpu_torch.probes")
    _build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    rep = probes.run(device="cuda", seed=0)
    wall = time.time() - t0
    launches.update({k: _build.LAUNCHES[k] for k in PROBES})
    if rep.failures:
        fail(f"probes: {len(rep.failures)} case(s) failed: {rep.failures}")
    if not all(launches[k] for k in PROBES):
        fail(f"probes: a kernel was not launched: "
             f"{ {k: launches[k] for k in PROBES} }")
    for k in PROBES:
        st = rep.stats[k]
        n_lib = st["library_cases"]
        stats[k].update(
            max_abs_err=st["max_abs_err"], ms=st["ms"],
            device_ms=st["device_ms"], plain_ms=st["plain_ms"],
            bound_ms=st["bound_ms"],
            bound_by="bytes" if st["bound_bytes_ms"] >= st["bound_ops_ms"]
            else "operations",
            library_ms=st["library_ms"] if n_lib else None,
            library_device_ms=st["library_device_ms"] if n_lib else None,
            library_kernel_device_ms=st["library_kernel_device_ms"]
            if n_lib else None)
        libs = (f"on the {n_lib} cases that are one PyTorch call, kernel "
                f"{st['library_kernel_device_ms']:.5f} ms device, "
                f"{st['library_kernel_ms']:.5f} ms a call (host), against "
                f"{st['library_device_ms']:.5f} and "
                f"{st['library_ms']:.5f} ms") if n_lib else \
            "no case is one PyTorch call"
        say(f"[7] {k}: {st['compared']} runs equal to the plain twin; "
            f"kernel {st['device_ms']:.5f} ms device, {st['ms']:.5f} ms a "
            f"call (host), plain {st['plain_ms']:.1f} ms, {show(stats[k])} "
            f"in all (loops at 64 and 2048 steps); {libs}; launches "
            f"{launches[k]}")
    say(f"[7] probes: every case equal ({wall:.1f} s) on {card}")
    # P1 and P2 on their edge inputs: the types' ends, an odd size, views
    # one value past an aligned start (the kernel's scalar path)
    rng = np.random.default_rng(7)
    n_edge = 0
    for mod, fn, carry, dtypes in (
            (subint32, subint32.probe, subint32.probe_carry,
             subint32.DTYPES),
            (lowprec, lowprec.elementwise, lowprec.in_carry,
             lowprec.DTYPES)):
        for dt in dtypes:
            for kind in kbench.PROBE_EDGE_KINDS:
                for op in mod.BINOPS:
                    for f in (fn, carry):
                        x, y = kbench.probe_edge_pair(rng, dt, kind, dev)
                        got, want = f(op, x, y, dev), f(op, x, y, "cpu")
                        if not torch.equal(got.cpu(), want):
                            fail(f"{f.__module__}.{f.__name__} {dt} {op} "
                                 f"on {kind} edges: kernel != plain")
                        n_edge += 1
    say(f"[7] P1 and P2 equal to plain on {n_edge} edge runs: every op, "
        f"alone and in the carry, at the types' ends "
        f"({', '.join(kbench.PROBE_EDGE_KINDS)})")
    rng = np.random.default_rng(1)
    for dt in lowprec.STEP_DTYPES:
        for B in (128, 1024):
            cases = [lowprec.step_inputs(rng, dt, dev, B=B)]
            if dt == "int16":                        # adds that wrap
                cases.append(lowprec.step_inputs(rng, dt, dev, B,
                                                 *lowprec.WRAP_RANGE))
            for x, dd in cases:
                for n in (64, lowprec.STEPS):
                    got, ms = timed(torch, lambda: lowprec.step_loop(
                        x, dd, n, dev))
                    want, pms = timed(torch, lambda: lowprec.step_timer_plain(
                        x, dd, n))
                    if not torch.equal(got, want):
                        fail(f"step timer {dt} B={B} {n} steps: kernel != "
                             f"plain")
        x, dd = cases[0]
        ns = [lowprec.step_timer(x, dd, k, dev).ns_per_step
              for k in (lowprec.STEPS, lowprec.LONG_STEPS)]
        say(f"[7] step timer {dt} W=64 B=1024: {ns[0]:.1f} ns/step at "
            f"{lowprec.STEPS} steps, {ns[1]:.1f} at {lowprec.LONG_STEPS} "
            f"(kernel equal to plain at 64 and {n} steps at B 128 and 1024"
            f"{', and from inputs that wrap' if dt == 'int16' else ''}; at "
            f"{n} steps kernel {ms:.3f} ms, plain {pms:.1f} ms) on {card}")

    # ---- 9: the parallel paths
    launches["lookup"] = phase9(np, torch, card, stats, ref_fa, reads_fq)

    # ---- 8
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "minialign_tpu"))
    if bad:
        fail(f"imported {bad}")
    print(card)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=tpu,
             launches=launches[k], **stats[k])
        for k, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
