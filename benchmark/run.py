"""One run of one benchmark cell of minialign_tpu_torch:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (all of it in setup_s): the cell's genome as FASTA and a read
pool as FASTQ, made from the seed under $TMPDIR; the index built by the
port's CLI path (cli.parse_argv / finalize / make_params, then
cli._iter_index_blocks, which calls index.build.build_index); the engine
made as cli.main makes it on one card (extend.FillEngine); one small
warm-up batch, not counted.

The window drives the CLI's single-process mapping loop (the -t1 branch
of cli._map_block) batch by batch: io.bseq.read_batches on the FASTQ at
the CLI's default batch size, pipeline.align_batch on the engine, and
io.sam.SamWriter into an in-memory sink that counts and hashes the
bytes. It ends on the first batch that completes after --seconds
(window.py). After it, the judge (judge.py) holds a sample of what it
printed, and the program's index, against the plain reference.

--trace 0 prints the cell's end-to-end metrics, --trace 1 its per-layer
ones, from a run under torch.profiler with the harness's spans around
each layer. The last line of standard output is the result as JSON.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

from . import gen, judge, spec, trace, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "minialign_tpu")


class Sink:
    """The SAM stream: counted and hashed, kept only where captured."""

    def __init__(self):
        self.nbytes = 0
        self.sha = hashlib.sha256()
        self.cap = None

    def write(self, s: str) -> None:
        b = s.encode()
        self.nbytes += len(b)
        self.sha.update(b)
        if self.cap is not None:
            self.cap.append(s)


class NullSink:
    def write(self, s: str) -> None:
        pass


class Spans:
    def __init__(self):
        self.d = {k: [] for k in trace.SPAN_ORDER}

    def add(self, name: str, t0: int, t1: int) -> None:
        self.d[name].append((t0, t1))


class EngineProxy:
    """Stands in for the engine in a traced run: times each engine.run and
    counts the moves that the walk made; everything else is the engine's
    (align_batch takes its engine as an argument)."""

    def __init__(self, engine, spans: Spans, counters: dict):
        self._e = engine
        self._spans = spans
        self._c = counters
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._e, name)

    def run(self, reqs):
        t0 = time.perf_counter_ns()
        out = self._e.run(reqs)
        t1 = time.perf_counter_ns()
        moves = probs = 0
        for req, o in zip(reqs, out):
            s, i, j = (o[3], o[4], o[5]) if req[0] == "duo" else o[:3]
            if req[0] != "down" and s > 0:
                moves += i + j
                probs += 1
        with self._lock:
            self._spans.add("engine.run", t0, t1)
            self._c["walk_moves"] += moves
            self._c["walk_problems"] += probs
        return out


def _count_fills(extend_mod, held: list):
    """Keeps each fill's per-problem step counts (a traced run only)."""
    orig = extend_mod.fill_store

    def fill_store(p, W, max_blocks, traced, *a, **kw):
        r = orig(p, W, max_blocks, traced, *a, **kw)
        res = r if hasattr(r, "n_steps") else r[0]
        held.append((W, bool(traced), res.n_steps))
        return r
    extend_mod.fill_store = fill_store
    return orig


def _fill_counters(held: list, counters: dict) -> None:
    import torch
    for tr in (False, True):
        key = "traced" if tr else "untraced"
        for W in sorted({w for w, t, _ in held if t == tr}):
            ns = [x for w, t, x in held if t == tr and w == W]
            steps = int(torch.cat([x.reshape(-1).to(torch.int64)
                                   for x in ns]).sum())
            counters[f"fill_steps.{key}"] += steps
            counters[f"fill_cells.{key}"] += W * steps
            counters[f"fill_problems.{key}"] += sum(int(x.numel())
                                                    for x in ns)


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _union_ns(iv: list) -> int:
    tot, end = 0, None
    for a, b in sorted(iv):
        if end is None or a > end:
            tot += b - a
            end = b
        elif b > end:
            tot += b - end
            end = b
    return tot


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
             device: str, workdir: str, t_start: float | None = None,
             sample=(48, 8), n_blocks: int = 16) -> dict:
    """Set-up, window and judge of one run. Returns the readings that the
    metric readers take (`ctx`), the checks and the counts."""
    import torch

    t_start = time.monotonic() if t_start is None else t_start
    g = cfg["genome"]
    genome = gen.genome(seed, g["length"])
    fasta = os.path.join(workdir, "genome.fa")
    fastq = os.path.join(workdir, "reads.fq")
    with open(fasta, "wb") as f:
        f.write(gen.fasta_bytes(g["name"], genome))
    pool = gen.Pool.make(seed, genome, cfg["reads"],
                         int(mix["pool_mbases"] * 1e6))
    pool.write_fastq(fastq)

    from minialign_tpu_torch import __version__, _build, cli, extend, native
    from minialign_tpu_torch.device import resolve_device
    from minialign_tpu_torch.extend import FillEngine
    from minialign_tpu_torch.io import bseq
    from minialign_tpu_torch.io.sam import SamWriter
    from minialign_tpu_torch.params import MM_OMIT_REP
    from minialign_tpu_torch.pipeline import align_batch

    native.tune_malloc()
    argv = list(cfg["preset"]) + [fasta, fastq]
    o = cli.Opts(arg_line="minialign-tpu " + " ".join(argv))
    cli.parse_argv(o, argv)
    cli.finalize(o)
    if o.ecnt:
        raise ValueError(f"preset {cfg['preset']} refused")
    if o.batch_size != mix["batch_bases"]:
        raise ValueError(f"the CLI's batch is {o.batch_size} bases, the mix "
                         f"says {mix['batch_bases']}")
    ip, mp = cli.make_params(o)
    mp.score.check()
    t_idx = time.monotonic()
    rss = {"inputs": _rss_gb()}
    mi = next(cli._iter_index_blocks(o, [fasta], ip))
    index_build_s = time.monotonic() - t_idx
    rss["index"] = _rss_gb()
    dev = resolve_device(device)
    engine = FillEngine(mp.score, device=dev)
    sink = Sink()
    kw = dict(tags=tuple(o.tags), rg_line=o.rg_line, rg_id=o.rg_id,
              arg_line=o.arg_line, version=__version__,
              omit_rep=bool(o.flag & MM_OMIT_REP))
    wr = SamWriter(sink, **kw)
    wr.header(mi.names, mi.lens)

    def batches(size):
        return bseq.read_batches(fastq, batch_size=size,
                                 keep_qual=o.keep_qual, min_len=o.min_len,
                                 tags=tuple(o.tag_names))

    # warm-up: the first reads of the pool, not counted
    warm = next(batches(mix["warmup_bases"]))
    wwr = SamWriter(NullSink(), **kw)
    for s, reg in zip(warm, align_batch(mp, mi, [s.codes for s in warm],
                                        engine, base_qid=0,
                                        tbuf={"rlen": 0})):
        wwr.mapped(mi.names, mi.lens, mi.codes, s, reg)
    del warm
    if dev.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    rss["warm-up"] = _rss_gb()

    picks = judge.sample(gen._rng(seed, 3), pool.length, *sample)
    want = set(picks)
    seen: set = set()
    records: dict = {}
    spans = Spans()
    counters = dict.fromkeys(
        ["walk_moves", "walk_problems"]
        + [f"fill_{a}.{b}" for a in ("steps", "cells", "problems")
           for b in ("untraced", "traced")], 0)
    held: list = []
    eng = engine
    orig_fill = None
    if traced:
        eng = EngineProxy(engine, spans, counters)
        orig_fill = _count_fills(extend, held)
    launches0 = _build.LAUNCHES["fill"]
    shapes0 = len(_build.FUSED_SHAPES)
    tb = {"rlen": 0}
    state = {"n_reads": 0}
    pc = time.perf_counter_ns

    def process(item):
        i0, batch = item
        t0 = pc()
        regs = align_batch(mp, mi, [s.codes for s in batch], eng,
                           base_qid=state["n_reads"], tbuf=tb)
        t1 = pc()
        for s, reg in zip(batch, regs):
            i = int(s.name[1:])
            if i in want and i not in records:
                sink.cap = []
                wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
                records[i] = "".join(sink.cap)
                sink.cap = None
            else:
                wr.mapped(mi.names, mi.lens, mi.codes, s, reg)
        t2 = pc()
        if traced:
            spans.add("io.read", i0, t0)
            spans.add("pipeline.align_batch", t0, t1)
            spans.add("io.write", t1, t2)
        state["n_reads"] += len(batch)
        return len(batch), sum(len(s.codes) for s in batch)

    src = window.cycle(lambda: batches(o.batch_size))

    def next_batch():
        t0 = pc()
        b = next(src)
        for s in b:
            seen.add(int(s.name[1:]))
        return t0, b

    prof = None
    if traced and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        rf = record_function("bench.window")
        rf.__enter__()
    t_win = time.monotonic()
    host_t0 = pc()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    win = window.run(iter(next_batch, None), process, seconds)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    if prof is not None:
        torch.cuda.synchronize()
        rf.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    setup_s = t_win - t_start
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    dev_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    counters["fill_launches"] = _build.LAUNCHES["fill"] - launches0
    new = _build.FUSED_SHAPES[shapes0:]
    counters["fill_problems"] = sum(s[0] for s in new)
    if orig_fill is not None:
        extend.fill_store = orig_fill
        _fill_counters(held, counters)
    held.clear()
    dev_trace = None
    if prof is not None:
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        dev_trace = trace.read(path, host_t0, spans.d)
        os.remove(path)
    # the program's state goes before the reference runs
    del engine, eng, src
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.monotonic()
    checks, judged, failed = judge.judge(
        cfg["score"], genome, g["name"], pool, picks, seen, records,
        gen._rng(seed, 4), index=mi, k=cfg["index"]["k"],
        w=cfg["index"]["w"], n_blocks=n_blocks, device=device)
    judge_s = time.monotonic() - t_judge
    ab = spans.d["pipeline.align_batch"]
    ctx = {
        "window": win, "setup_s": setup_s, "index_build_s": index_build_s,
        "host_peak_bytes": host_peak, "device_peak_bytes": dev_peak,
        "spans": {k: sum(b - a for a, b in v) * 1e-9
                  for k, v in spans.d.items()},
        "engine_run_union_s": _union_ns(spans.d["engine.run"]) * 1e-9,
        "align_batch_s": sum(b - a for a, b in ab) * 1e-9,
        "counters": counters, "trace": dev_trace, "traced": traced,
        "judge_s": judge_s,
        "rusage": {"peak_gb_after_" + k: v for k, v in rss.items()} | {
            "window_cpu_s": (ru1.ru_utime + ru1.ru_stime
                             - ru0.ru_utime - ru0.ru_stime)},
    }
    return {"ctx": ctx, "checks": checks, "judged": judged,
            "failed": failed, "attempted": win.reads,
            "sam_bytes": sink.nbytes, "sam_sha256": sink.sha.hexdigest()}


def read_metric(name: str, ctx: dict):
    path = os.path.join(spec.HERE, "metrics", name + ".py")
    m = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(m)
    m.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    b = spec.benchmark()
    w, c, cfg, mix = spec.cell(b, a.workload)
    lim = spec.limits(a.workload)
    kind = "per_layer" if a.trace else "end_to_end"
    wanted = spec.metrics_of(b, a.workload, kind)
    th = mix["threads"]
    for k, v in th["env"].items():
        os.environ[k] = str(v)
    print("[bench] threads: " + " ".join(f"{k}={v}" for k, v in
                                         th["env"].items())
          + f" torch.set_num_threads={th['torch_intra_op']}",
          file=sys.stderr)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"[bench] needs {w['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(th["torch_intra_op"])
    with tempfile.TemporaryDirectory(prefix="bench-") as wd:
        r = run_cell(cfg, mix, a.seed, a.seconds, bool(a.trace), "cuda", wd,
                     T_START)
    bad = forbidden_modules()
    if bad:
        print(f"[bench] modules that the port may not load: {bad}",
              file=sys.stderr)
        return 3
    ctx = r["ctx"]
    metrics = {}
    for m in wanted:
        v = read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": w["chips"],
           "memory_peak_bytes": int(ctx["device_peak_bytes"])}
    out = {"correct": None, "attempted": r["attempted"],
           "failed": r["failed"], "metrics": metrics, "device": dev}
    if ctx["trace"] is not None:
        t = ctx["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    win = ctx["window"]
    bs = sorted(win.batch_s)
    print(f"[bench] batch seconds: min {bs[0]:.3f} median "
          f"{bs[len(bs) // 2]:.3f} max {bs[-1]:.3f}; first five "
          + " ".join(f"{x:.3f}" for x in win.batch_s[:5]), file=sys.stderr)
    print("[bench] window rusage: " + " ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in ctx["rusage"].items()), file=sys.stderr)
    print(f"[bench] card: {_power_limit()}; window {win.seconds:.3f} s, "
          f"{win.batches} batches, {win.reads} reads, {win.bases} bases; "
          f"SAM {r['sam_bytes']} bytes sha256 {r['sam_sha256'][:16]}; "
          f"judged {r['judged']} reads in {ctx['judge_s']:.3f} s; "
          f"setup {ctx['setup_s']:.3f} s, index {ctx['index_build_s']:.3f} s",
          file=sys.stderr)
    checks = {k: {"value": v, "limit": lim[k]} for k, v in
              r["checks"].items()}
    correct = r["judged"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out["correct"] = correct
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
