"""The control of the all-vs-all judge (modes/ava.py): the plain reference
put in the program's place, computed one precision below the
configuration's int32 scores: in saturating int16, as 16-bit SIMD
aligners compute, without their fall-back to 32 bits. For each sampled
read of a run (the same sample that a run of the cell judges) it prints
the self line and a PAF line for each true overlap, and aligns the read's
4 longest true overlaps over their true intersection (reference.band_dp
with moves under the linear model, then traceback), and hands these to
the same judge. The judge has to find it not correct; `--int32` runs the
same reference in int32, which it has to find correct. It prints no
false overlap, so its false_overlap and missed_overlap read 0.

    python3 -m benchmark.control_ava --workload <cell> --seeds 1,2,3 \
        [--int32] [--device cuda]

Prints one JSON line a seed and precision. Not run by the benchmark's
own runs.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from . import gen, judge as map_judge, reference as R, reference_ava as RA
from . import spec
from .modes import ava


def records(cfg: dict, pool, picks: list, int16: bool,
            device: str) -> tuple[dict, dict]:
    """(PAF text, path records) a pick, as modes/ava.py keeps them."""
    lin = RA.linear_score(cfg["score"])
    maps: dict = {}
    text, paths, jobs = {}, {}, []
    for i in picks:
        L = int(RA.read_map(pool, i)[-1])
        lines = [f"r{i}\t{L}\t0\t{L}\t+\tr{i}\t{L}\t0\t{L}\t{L}\t{L}\t60"]
        tov = [o for o in RA.true_overlaps(pool, i, maps)
               if o["qe"] > o["qs"] and o["te"] > o["ts"]]
        for o in tov:
            j = o["j"]
            n = max(o["qe"] - o["qs"], o["te"] - o["ts"])
            lines.append(f"r{i}\t{L}\t{o['qs']}\t{o['qe']}\t{o['strand']}\t"
                         f"r{j}\t{int(maps[j][-1])}\t{o['ts']}\t{o['te']}\t"
                         f"{n}\t{n}\t0")
        text[i] = "\n".join(lines) + "\n"
        paths[i] = []
        longest = sorted(range(len(tov)),
                         key=lambda n: tov[n]["qe"] - tov[n]["qs"],
                         reverse=True)
        jobs += [(i, 1 + n, tov[n]) for n in longest[:ava.PATHS_PER_READ]]
    refs, qrys, halves = [], [], []
    codes: dict = {}

    def get(x):
        if x not in codes:
            codes[x] = pool.codes(x)
        return codes[x]
    for i, _, o in jobs:
        refs.append(get(o["j"])[o["ts"]:o["te"]])
        qrys.append(RA.strand_seq(get(i), o["strand"])[o["qs"]:o["qe"]])
        err = 2.0 - float(pool.acc[i]) - float(pool.acc[o["j"]])
        halves.append(64 + 4 * math.sqrt(len(qrys[-1]) * err * 0.6))
    if jobs:
        half = int(min(1024, -(-max(halves) // 32) * 32))
        _, mv = R.band_dp(lin, refs, qrys, half, device=device, int16=int16,
                          moves=True)
        for p, (i, line, o) in enumerate(jobs):
            m, n = len(refs[p]), len(qrys[p])
            paths[i].append(dict(
                line=line, j=o["j"], strand=o["strand"], ts=o["ts"], te=o["te"],
                qs=o["qs"], qe=o["qe"],
                cigar=R.traceback(mv[p, :n + 1].cpu().numpy(), m, n, half)))
    return text, paths


def control(cfg: dict, mix: dict, seed: int, int16: bool, device: str,
            sample=(48, 8)) -> tuple[dict, int, int]:
    genome = gen.genome(seed, cfg["genome"]["length"])
    pool = gen.Pool.make(seed, genome, cfg["reads"],
                         ava.read_set_bases(cfg))
    picks = map_judge.sample(gen._rng(seed, 3),
                             pool.length[:ava.prefix_reads(pool)], *sample)
    text, paths = records(cfg, pool, picks, int16, device)
    return ava.judge(cfg["score"], pool, picks, set(picks), text, paths,
                     gen._rng(seed, 4), index=None, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control_ava")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--int32", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    b = spec.benchmark()
    _, _, cfg, mix = spec.cell(b, a.workload)
    lim = spec.limits(a.workload)
    for s in a.seeds.split(","):
        for int16 in ([True, False] if a.int32 else [True]):
            t0 = time.monotonic()
            v, judged, failed = control(cfg, mix, int(s), int16, a.device)
            ok = all(x <= lim[k] for k, x in v.items())
            print(json.dumps({"workload": a.workload, "seed": int(s),
                              "precision": "int16" if int16 else "int32",
                              "correct": ok, "judged": judged,
                              "failed": failed, "checks": v,
                              "seconds": time.monotonic() - t0}))
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
