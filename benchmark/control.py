"""The control of the judge: the plain reference put in the program's
place, computed one precision below the configuration's int32 scores:
in saturating int16, as 16-bit SIMD aligners compute, without their
fall-back to 32 bits. For each sampled read of a run (the same sample
that a run of the cell judges) it aligns the read over its true origin
(band_dp with moves, then traceback), prints that as the read's SAM
record, and hands the records to the same judge. The judge has to find
it not correct; `--int32` runs the same reference in int32, which it
has to find correct.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
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

from . import gen, judge, reference as R, spec


def aligned_records(cfg: dict, pool, picks: list, int16: bool,
                    device: str) -> dict:
    """SAM text a pick: its read aligned over its true origin."""
    genome = pool.genome
    refs, qrys, halves = [], [], []
    for i in picks:
        read = pool.codes(i)
        q = (3 - read[::-1]) if pool.rev[i] else read
        s, ln = int(pool.start[i]), int(pool.length[i])
        refs.append(genome[s:s + ln])
        qrys.append(q)
        err = 1.0 - float(pool.acc[i])
        halves.append(64 + 4 * math.sqrt(len(q) * err * 0.6))
    half = int(min(1024, -(-max(halves) // 32) * 32))
    _, mv = R.band_dp(cfg["score"], refs, qrys, half, device=device,
                      int16=int16, moves=True)
    out = {}
    for p, i in enumerate(picks):
        m, n = len(refs[p]), len(qrys[p])
        cig = R.traceback(mv[p, :n + 1].cpu().numpy(), m, n, half)
        rev = bool(pool.rev[i])
        out[i] = (f"r{i}\t{16 if rev else 0}\t{cfg['genome']['name']}\t"
                  f"{int(pool.start[i]) + 1}\t60\t{cig}\t*\t0\t0\t"
                  f"{gen.BASES[qrys[p]].tobytes().decode()}\t*\n")
    return out


def control(cfg: dict, mix: dict, seed: int, int16: bool, device: str,
            sample=(48, 8)) -> tuple[dict, int, int]:
    genome = gen.genome(seed, cfg["genome"]["length"])
    pool = gen.Pool.make(seed, genome, cfg["reads"],
                         int(mix["pool_mbases"] * 1e6))
    picks = judge.sample(gen._rng(seed, 3), pool.length, *sample)
    recs = aligned_records(cfg, pool, picks, int16, device)
    return judge.judge(cfg["score"], genome, cfg["genome"]["name"], pool,
                       picks, set(picks), recs, gen._rng(seed, 4),
                       index=None, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
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
