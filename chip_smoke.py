#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minialign_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  0  the card's name and power limit (nvidia-smi); CUDA must be present
  1  build the kernels from csrc/ with nvcc (sm_90a)
  2  K2 gather kernel == gather_plain, byte for byte, on a 5 Mb store
  3  K1 fill kernel == fill_plain (both score models x W 16/32/64 x
     trace on/off at B=128, ~4 kb; W=64 at 20 kb), with times
  4  K3 traceback kernel == dtrace_plain on phase 3's trace buffers
  5  the goldens through the port's CLI on CUDA (ref_out, ref_pacbio,
     ref_tags), every kernel launched
  6  real size: bench_e2e.make_workload's 5 Mb genome and 100 x 20 kb
     reads mapped with -t1 -xpacbio; the SAM (without @PG) must hash to
     the JAX package's digest below
  7  the step-mix probes P1-P4 through their entry point
     (minialign_tpu_torch.probes.run, i.e. python -m
     minialign_tpu_torch.probes): every case of the four JAX tools, each
     kernel exactly equal to its plain twin (loops at 64 and 2048 steps),
     ns/step at the tools' own counts (the step timer also at 2^17
     steps); then the step timer at B=1024
  8  no jax imported; the kernels' JSON line, then the result line

The port never imports JAX; the digests below were taken with the JAX
package on a CPU.
"""

import hashlib
import io
import json
import os
import subprocess
import sys
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
E2E_READS = 100
E2E_SHA256 = ("ac52c9b48c971877583630a173e387fc"
              "189fb403037d3baf904dcfbdfb91832a")
# The JAX package's own output (SAM without @PG) for the goldens' inputs.
# ref_out.sam and ref_pacbio.sam equal the reference binary's goldens;
# for -T...,MD the reference binary's MD differs on reverse-strand
# records (PARITY.md item 1), so that case is held to the JAX output,
# and to the golden apart from that field.
GOLDENS = (
    (["-t1"], "ref_out.sam",
     "8e3128188f38530feac41f4f692962be4a3c4a857d436ec023b8621b9ffcc56a"),
    (["-t1", "-xpacbio"], "ref_pacbio.sam",
     "dfea3e049504c9c36b69dff10e189b8a9d4864666b43028839504c3044fcd80c"),
    (["-t1", "-TAS,NM,MD,XS,NH,IH"], "ref_tags.sam",
     "ca8ef1579be1513f83b3c0696b704309d3513be8c2f340ecca97bbbc2b3d2b84"),
)
KERNELS = {
    "fill": ("minialign_tpu_torch/csrc/fill.cu",
             "minialign_tpu/dp/pallas_fill.py:663"),
    "gather": ("minialign_tpu_torch/csrc/gather.cu",
               "minialign_tpu/dp/pallas_gather.py:83"),
    "dtrace": ("minialign_tpu_torch/csrc/dtrace.cu",
               "minialign_tpu/dp/dtrace.py:66"),
    "p1": ("minialign_tpu_torch/csrc/probe_subint32.cu",
           "tests/tools/probe_subint32.py:15"),
    "p2": ("minialign_tpu_torch/csrc/probe_lowprec.cu",
           "tests/tools/probe_lowprec.py:37"),
    "p3": ("minialign_tpu_torch/csrc/probe_bf16ops.cu",
           "tests/tools/probe_bf16ops.py:32"),
    "p4": ("minialign_tpu_torch/csrc/probe_wordstream.cu",
           "tests/tools/probe_wordstream.py:26"),
}
MAPPER = ("fill", "gather", "dtrace")        # the CLI's kernels
PROBES = ("p1", "p2", "p3", "p4")            # the probes' kernels


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def timed(torch, fn, reps=1):
    """(result, median ms) of fn() over reps runs, timed with CUDA
    events around each run."""
    out, ts = None, []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return out, sorted(ts)[len(ts) // 2]


def mutate(np, rng, a, err=0.12):
    """~err edits: 40% substitutions, 30% deletions, 30% insertions."""
    r = rng.random(len(a))
    b = np.where(r < 0.4 * err, rng.integers(0, 4, len(a)), a)
    reps = np.where(r < 0.4 * err, 1, np.where(r < 0.7 * err, 0,
                                               np.where(r < err, 2, 1)))
    out = np.repeat(b, reps)
    ins = np.cumsum(reps)[reps == 2] - 1
    out[ins] = rng.integers(0, 4, len(ins))
    return out


def sam_digest(text):
    body = "".join(line for line in text.splitlines(keepends=True)
                   if not line.startswith("@PG"))
    return hashlib.sha256(body.encode()).hexdigest(), body


def drop_reverse_md(text):
    """SAM text without the MD field of reverse-strand records, where
    the reference binary's MD is wrong (PARITY.md item 1)."""
    out = []
    for line in text.splitlines():
        f = line.split("\t")
        if not line.startswith("@") and int(f[1]) & 0x10:
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


def main():
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        import torch

        from minialign_tpu_torch import _build
    except ImportError as e:
        fail(f"minialign_tpu_torch is not importable from {ROOT}: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from minialign_tpu.params import MapParams, ScoreParams
    from minialign_tpu_torch import cli
    from minialign_tpu_torch.dp import band, cuda_fill, cuda_gather, dtrace
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

    # ---- 2: K2 gather on a 5 Mb (fwd + revcomp) store
    rng = np.random.default_rng(1)
    G = 5_000_000
    store = torch.from_numpy(rng.integers(0, 5, 2 * G).astype(np.int8)).to(
        dev)
    B, L = 512, 32768
    base = rng.integers(0, 2, B) * G
    seglen = np.full(B, G)
    start = rng.integers(0, G, B)
    start[:4] = [G - 1, G, G - 100, 0]          # the store's segment ends
    cap = rng.integers(L // 2, L + 1, B)
    cap[4:8] = 0                                 # ln = 0
    wrap = np.zeros(B, np.int64)
    wrap[8:40] = G                               # circular windows
    start[8:12] = G - rng.integers(1, 1000, 4)
    meta = (base, start, cap, seglen, wrap)
    got, ms = timed(torch, lambda: cuda_gather.gather(store, *meta, L), 5)
    want, pms = timed(torch, lambda: cuda_gather.gather_plain(store, *meta,
                                                              L), 3)
    if not torch.equal(got, want):
        fail("gather kernel != gather_plain")
    stats["gather"].update(max_abs_err=int((got.int() - want.int()).abs()
                                           .max()), ms=ms, plain_ms=pms)
    say(f"[2] gather B={B} L={L}: equal; kernel {ms:.3f} ms, plain "
        f"{pms:.3f} ms ({B * L / ms / 1e6:.2f} GB/s kernel) on {card}")

    # ---- 3: K1 fill; 4: K3 walk on its trace buffers
    pr = {"affine": MapParams().score,
          "combined": ScoreParams(matrix=tuple(
              2 if (i & 3) == (i >> 2) else -4 for i in range(16)),
              gi=4, ge=2, gfa=3, gfb=3, xdrop=50)}   # the -xpacbio scores

    def pairs(seed, B, n):
        rng = np.random.default_rng(seed)
        a = [rng.integers(0, 4, int(rng.normal(n, n * 0.05)))
             for _ in range(B)]
        b = [mutate(np, rng, s) for s in a]
        ab, alen = band.pad_codes(a)
        bb, blen = band.pad_codes(b)
        return [torch.from_numpy(x).to(dev) for x in (ab, alen, bb, blen)]

    err = {"fill": 0, "dtrace": 0}

    def check_fill(p, W, trace, args, reps=1):
        nb = band.max_blocks_for(args[1].cpu().numpy(),
                                 args[3].cpu().numpy())
        got, ms = timed(torch, lambda: cuda_fill.fill_cuda(
            p, W, nb, trace, *args), reps)
        want, pms = timed(torch, lambda: band.fill_plain(
            p, W, nb, trace, *args))
        rk, rp = (got[0], want[0]) if trace else (got, want)
        for f in ("max_score", "max_i", "max_j", "n_steps", "n_blocks"):
            d = int((getattr(rk, f) - getattr(rp, f)).abs().max())
            err["fill"] = max(err["fill"], d)
            if d:
                fail(f"fill W={W} trace={trace}: {f} differs by {d}")
        if trace:
            own = (rk.n_steps // band.BLK).tolist()
            for f in ("masks", "dirs", "iheads", "rprevs"):
                xk, xp = getattr(got[1], f), getattr(want[1], f)
                for k, n in enumerate(own):
                    if not torch.equal(xk[k, :n], xp[k, :n]):
                        fail(f"fill W={W}: trace {f} differs, problem {k}")
        return got, ms, pms

    def check_walk(p, W, res, bufs, reps=1):
        walk = (bufs.masks, bufs.dirs, bufs.iheads, res.max_score,
                res.max_i, res.max_j)
        (rk, sk), ms = timed(torch, lambda: dtrace.dtrace(p, W, *walk),
                             reps)
        (rp, sp), pms = timed(torch, lambda: dtrace.dtrace_plain(
            p, W, *walk))
        err["dtrace"] = max(err["dtrace"], int((sk - sp).abs().max()))
        if not (torch.equal(sk, sp) and torch.equal(rk, rp)):
            fail(f"dtrace W={W}: kernel != dtrace_plain")
        bad = int(sk[dtrace.SUMMARY_ROWS.index("bad")].sum())
        return ms, pms, bad

    t0 = time.time()
    for pname, p in pr.items():
        for W in (16, 32, 64):
            args = pairs(W, 128, 4000)
            for trace in (False, True):
                got, ms, pms = check_fill(p, W, trace, args)
                if trace:
                    check_walk(p, W, *got)
    say(f"[3/4] fill and walk equal to plain: 2 models x W 16/32/64 x "
        f"trace on/off, B=128, ~4 kb ({time.time() - t0:.0f} s)")

    args = pairs(7, 128, 20000)
    for trace in (False, True):
        got, ms, pms = check_fill(pr["affine"], 64, trace, args, reps=3)
        res = got[0] if trace else got
        cells = int(res.n_steps.sum()) * 64
        say(f"[3] fill W=64 affine B=128 L=20kb trace={trace}: equal; "
            f"kernel {ms:.2f} ms ({cells / ms / 1e6:.1f} GCUPS), plain "
            f"{pms:.1f} ms ({cells / pms / 1e6:.3f} GCUPS) on {card}")
        if trace:
            stats["fill"].update(ms=ms, plain_ms=pms)
            wms, wpms, bad = check_walk(pr["affine"], 64, *got, reps=3)
            stats["dtrace"].update(ms=wms, plain_ms=wpms)
            say(f"[4] walk W=64 B=128 L=20kb: equal ({bad} out of band); "
                f"kernel {wms:.2f} ms, plain {wpms:.1f} ms on {card}")
    got, ms, pms = check_fill(pr["combined"], 64, True, args, reps=3)
    cells = int(got[0].n_steps.sum()) * 64
    say(f"[3] fill W=64 combined (-xpacbio scores) B=128 L=20kb trace=True:"
        f" equal; kernel {ms:.2f} ms ({cells / ms / 1e6:.1f} GCUPS), plain "
        f"{pms:.1f} ms on {card}")
    stats["fill"]["max_abs_err"] = err["fill"]
    stats["dtrace"]["max_abs_err"] = err["dtrace"]
    del got, args, store

    # ---- 5: goldens through the CLI on CUDA
    os.environ["MINIALIGN_TORCH_DEVICE"] = "cuda"
    for args, golden, jax_sha in GOLDENS:
        _build.reset_counts()
        t0 = time.time()
        out = run_cli(cli, args + [f"{DATA}/tref.fa", f"{DATA}/treads.fq"])
        dt = time.time() - t0
        counts = {k: _build.LAUNCHES[k] for k in MAPPER}
        if not all(counts.values()):
            fail(f"{golden}: a kernel was not launched: {counts}")
        sha, body = sam_digest(out)
        if sha != jax_sha:
            fail(f"{golden}: SAM digest {sha} != JAX package's {jax_sha}")
        with open(os.path.join(DATA, golden)) as f:
            want = sam_digest(f.read())[1]
        note = ""
        if golden == "ref_tags.sam":
            body, want = drop_reverse_md(body), drop_reverse_md(want)
            note = " apart from reverse-strand MD"
        if body != want:
            fail(f"{golden}: not byte-identical modulo @PG{note}")
        say(f"[5] {golden}: identical{note} ({dt:.1f} s, launches "
            f"{counts})")

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
    _build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = run_cli(cli, ["-t1", "-xpacbio", ref_fa, reads_fq])
    wall = time.time() - t0
    launches = {k: _build.LAUNCHES[k] for k in MAPPER}
    sha, body = sam_digest(out)
    if sha != E2E_SHA256:
        fail(f"real-size SAM digest {sha} != JAX package's {E2E_SHA256}")
    if not all(launches.values()):
        fail(f"real size: a kernel was not launched: {launches}")
    recs = sum(1 for line in body.splitlines() if not line.startswith("@"))
    say(f"[6] real size -t1 -xpacbio: SAM identical to the JAX package's "
        f"({recs} records); wall {wall:.2f} s, {nbases / wall / 1e6:.3f} "
        f"Mbases/s, launches {launches} on {card}")

    # ---- 7: the probes' entry point, then the step timer at B=1024
    from minialign_tpu_torch import probes
    from minialign_tpu_torch.probes import lowprec
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
        stats[k].update(max_abs_err=st["max_abs_err"], ms=st["ms"],
                        plain_ms=st["plain_ms"])
        say(f"[7] {k}: {st['compared']} runs equal to the plain twin; "
            f"kernel {st['ms']:.3f} ms, plain {st['plain_ms']:.1f} ms in all "
            f"(loops at 64 and 2048 steps); launches {launches[k]}")
    say(f"[7] probes: every case equal ({wall:.1f} s) on {card}")
    rng = np.random.default_rng(1)
    for dt in lowprec.STEP_DTYPES:
        x, dd = lowprec.step_inputs(rng, dt, dev, B=1024)
        for n in (64, lowprec.STEPS):
            got, ms = timed(torch, lambda: lowprec.step_loop(x, dd, n, dev))
            want, pms = timed(torch, lambda: lowprec.step_timer_plain(x, dd,
                                                                       n))
            if not torch.equal(got, want):
                fail(f"step timer {dt} B=1024 {n} steps: kernel != plain")
        ns = [lowprec.step_timer(x, dd, k, dev).ns_per_step
              for k in (lowprec.STEPS, lowprec.LONG_STEPS)]
        say(f"[7] step timer {dt} W=64 B=1024: {ns[0]:.1f} ns/step at "
            f"{lowprec.STEPS} steps, {ns[1]:.1f} at {lowprec.LONG_STEPS} "
            f"(kernel equal to plain at 64 and {n} steps; at {n} steps "
            f"kernel {ms:.3f} ms, plain {pms:.1f} ms) on {card}")

    # ---- 8
    if "jax" in sys.modules:
        fail("jax was imported")
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
