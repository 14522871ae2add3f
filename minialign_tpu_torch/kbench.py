"""Times the fill (K1) and walk (K3) kernels at the main path's shapes,
and profiles the end-to-end run, on one CUDA card.

    python minialign_tpu_torch/kbench.py [--root DIR] [--batches 128,8]
        [--reps 3] [--e2e]

Kernels: W = 64, the -xpacbio (combined) scores, the first B of 128
seeded pairs of ~20 kb with ~12% edits (chip_smoke.py's phase 3 set),
for each B of --batches: the traced and the untraced fill and the walk
on the traced fill's buffers, each the median of --reps windows of
CALLS calls timed with CUDA events. --e2e maps bench_e2e.make_workload's
100 x 20 kb reads on a 5 Mb genome with -t1 -xpacbio: one warm-up,
three timed runs (host clock, ending in a synchronize), then one under
torch.profiler, whose device events give the busy share and the time
per kernel.

--root DIR imports minialign_tpu_torch from DIR instead of this
checkout, so that one call can time two commits on one card (unpack
the other with git archive). Every result is one JSON line with the
card's name and power limit.
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
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_READS = 100
CALLS = 5       # kernel calls a timed window: ~15-30 ms at 20 kb


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


def card():
    """nvidia-smi's name and power limit of the card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi gave nothing"


def kernels(torch, pkg, batches, reps, emit):
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


def device_busy(trace_path):
    """(busy ms, wall ms of the traced window, {kernel: [ms, launches]})
    from a chrome trace: device events are the kernels, copies and
    sets; busy is the union of their intervals."""
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
        k = e["name"] if e["cat"] == "kernel" else e["cat"]
        per.setdefault(k, [0.0, 0])
        per[k][0] += e["dur"] / 1e3
        per[k][1] += 1
    return busy / 1e3, (t1 - t0) / 1e3, per


def e2e(torch, pkg, emit):
    from minialign_tpu_torch import _build, cli
    os.environ.update(BENCH_E2E_GENOME_MB="5", BENCH_E2E_READS=str(E2E_READS),
                      BENCH_E2E_READLEN="20000",
                      MINIALIGN_TORCH_DEVICE="cuda")
    sys.path.insert(0, HERE)
    import bench_e2e
    bench_e2e.CACHE = os.path.join(HERE, "minialign_tpu_torch", "build",
                                   "e2e")
    ref_fa, reads_fq, _ = bench_e2e.make_workload()
    with open(reads_fq) as f:
        nbases = sum(len(line.rstrip()) for i, line in enumerate(f)
                     if i % 4 == 1)

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
    _build.reset_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    batches = sorted(getattr(_build, "TRACED_FILL_B", []))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        busy, wall, per = device_busy(path)
    emit(kind="e2e", pkg=pkg, bases=nbases, first_s=first, walls_s=walls,
         mbases_per_s=[nbases / w / 1e6 for w in walls],
         profiled_wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
         launches=dict(_build.LAUNCHES), traced_fill_batches=batches,
         traced_fill_batch_median=(batches[len(batches) // 2]
                                   if batches else None),
         per_kernel_ms={k: round(v[0], 3) for k, v in per.items()},
         per_kernel_launches={k: v[1] for k, v in per.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--batches", default="128,8")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--e2e", action="store_true")
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

    kernels(torch, pkg, [int(x) for x in o.batches.split(",")], o.reps,
            emit)
    if o.e2e:
        e2e(torch, pkg, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
