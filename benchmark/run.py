"""One run of one benchmark cell of minialign_tpu_torch:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The frame here is the same for every cell; what a cell's traffic does
is its mode's (modes/<mode>.py, named by the traffic file's "mode" key,
found by spec.mode; modes/__init__.py lists the hooks). A mode with no
file, or limits whose keys are not the mode's checks, stop the run
before any set-up.

Set-up (all of it in setup_s, from T_START): the mode's inputs, made
from the seed under $TMPDIR; its CLI options; its index, built by the
port's CLI path (timed alone: index_build_s); its engine and writer;
its warm-up batch, not counted. The window (window.py) runs the mode's
batches through its `process` until the first batch that completes
after --seconds; the output goes into an in-memory sink that counts and
hashes the bytes. After it, the program's state is freed and the mode's
judge holds a sample of what it printed against the plain reference.

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

from . import program, spec, trace, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "minialign_tpu")


class Sink:
    """The output stream: counted and hashed, kept only where captured."""

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


class Spans:
    def __init__(self):
        self.d = {k: [] for k in trace.SPAN_ORDER}

    def add(self, name: str, t0: int, t1: int) -> None:
        self.d[name].append((t0, t1))


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
    """Set-up, window and judge of one run, the steps of the mix's mode
    (modes/<mode>.py) between the frame's. Returns the readings that the
    metric readers take (`ctx`), the checks and the counts."""
    import torch

    t_start = time.monotonic() if t_start is None else t_start
    m = spec.mode(mix).Mode(cfg, mix, seed, device, workdir,
                            sample=sample, n_blocks=n_blocks)
    cuda = torch.device(device).type == "cuda"
    m.inputs()
    m.prepare()
    t_idx = time.monotonic()
    rss = {"inputs": _rss_gb()}
    m.index()
    index_build_s = time.monotonic() - t_idx
    rss["index"] = _rss_gb()
    m.engine()
    sink = Sink()
    m.writer(sink)
    m.warm_up()
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    rss["warm-up"] = _rss_gb()

    spans = Spans()
    counters: dict = {}
    batches, process = m.open_window(spans, counters, traced)
    pc = time.perf_counter_ns
    prof = None
    if traced and cuda:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        rf = record_function("bench.window")
        rf.__enter__()
    t_win = time.monotonic()
    host_t0 = pc()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    win = window.run(batches, process, seconds)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    if prof is not None:
        torch.cuda.synchronize()
        rf.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    setup_s = t_win - t_start
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    dev_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    m.end_window(counters)
    dev_trace = None
    if prof is not None:
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        dev_trace = trace.read(path, host_t0, spans.d,
                               program.intervals())
        os.remove(path)
    # the program's state goes before the reference runs
    del batches, process
    m.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.monotonic()
    checks, judged, failed = m.judge()
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
            "out_bytes": sink.nbytes, "out_sha256": sink.sha.hexdigest()}


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
    lim = spec.limits(a.workload, spec.mode(mix).CHECKS)
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
          f"output {r['out_bytes']} bytes sha256 {r['out_sha256'][:16]}; "
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
