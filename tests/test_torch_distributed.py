"""The port's multi-host and worker-process paths on the CPU
(minialign_tpu_torch.parallel.distributed, hostworker, dist_host and the
CLI's -tN workers) against the JAX package's: the batch plan, the chain
check, the worker count, the per-host files byte for byte (each
package's merge takes the other's), a forced remap, two hosts joined
by a gloo coordinator, and the CLI's worker processes, each merged
output equal to one process's, @PG included.

The reads are ~1 kb slices of tests/data/tref.fa with ~7% edits, made
from a numpy seed, in two files: three batches at -165537, a full one
and two short ones (kbench.write_split_reads). Every process runs on the
CPU with one torch thread and one scheduler thread."""

import io
import json
import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

import minialign_tpu.cli as jcli
import minialign_tpu.parallel.distributed as jdist
import minialign_tpu_torch.cli as tcli
import minialign_tpu_torch.parallel.distributed as tdist
from minialign_tpu_torch import kbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
BATCH = 65537           # the smallest legal -1 (> 64k, mm_opt_batch)


def cpu_env(**extra):
    env = dict(os.environ, MINIALIGN_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               MINIALIGN_SCHED_WORKERS="1")
    for k in ("MINIALIGN_PROC_WORKERS", "MINIALIGN_SHARD", "MINIALIGN_DUO"):
        env.pop(k, None)
    env.update(extra)
    return env


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(args, **env):
    return subprocess.Popen([sys.executable, "-m"] + args, cwd=ROOT,
                            env=cpu_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def finish(p, timeout=600):
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err.decode()[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's runs on the same argv, started together: one CLI
    process, the CLI with MINIALIGN_PROC_WORKERS=2, and two dist_host
    processes joined by a gloo coordinator on a free local port. Then the
    JAX package's run_host files for both hosts."""
    d = tmp_path_factory.mktemp("dist")
    reads = [str(d / "reads1.fq"), str(d / "reads2.fq")]
    kbench.write_split_reads(reads, BATCH)
    argv = ["-t1", f"-1{BATCH}", os.path.join(DATA, "tref.fa")] + reads
    coord = f"127.0.0.1:{free_port()}"
    hosts = [str(d / f"port{h}.out") for h in range(2)]
    procs = [start(["minialign_tpu_torch"] + argv),
             start(["minialign_tpu_torch"] + argv,
                   MINIALIGN_PROC_WORKERS="2")]
    procs += [start(["minialign_tpu_torch.parallel.dist_host", str(h), "2",
                     coord, hosts[h]] + argv) for h in range(2)]
    single, workers = finish(procs[0]), finish(procs[1])
    for p in procs[2:]:
        finish(p)
    jax_hosts = [str(d / f"jax{h}.out") for h in range(2)]
    for h in range(2):
        jdist.run_host(argv, jax_hosts[h], h, 2)
    return dict(argv=argv, dir=d, single=single.decode(),
                workers=workers.decode(), hosts=hosts, jax_hosts=jax_hosts)


@pytest.fixture
def on_cpu(monkeypatch):
    """This process as the subprocesses run: the CPU, one torch thread,
    one scheduler thread."""
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MINIALIGN_SCHED_WORKERS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def merged(mod, argv, paths):
    out = io.StringIO()
    n = mod.merge_host_outputs(list(argv), paths, out)
    return out.getvalue(), n


# ---- the plan, the chain check, the worker count


def test_plan_equal_and_three_batches(runs):
    """_plan's batches, ranks and base qids across the two query files
    equal the JAX package's."""
    def plan(mod):
        o, _, blocks, queries, _, _ = mod._align_setup(runs["argv"])
        return [(r, bi, q, [s.name for s in b])
                for r, bi, q, b in mod._plan(o, queries, blocks)]
    got, want = plan(tdist), plan(jdist)
    assert got == want
    assert len(got) == 3


def test_host_batches_partition():
    batches = [f"batch{i}" for i in range(11)]
    seen = {}
    for h in range(3):
        got = list(tdist.host_batches(batches, h, 3))
        assert got == list(jdist.host_batches(batches, h, 3))
        for rank, b in got:
            assert rank not in seen and batches[rank] == b
            seen[rank] = h
    assert sorted(seen) == list(range(11))


def _e(first, fired, out_rlen, qlen=1000):
    return {"first": first, "fired": fired, "out_rlen": out_rlen,
            "qlen": qlen}


CHAINS = {
    "empty": ([], 7),
    "unmapped_reads": ([None, None], 7),
    "no_root": ([_e(None, False, None), _e(None, False, 900)], 0),
    "holds": ([_e([10, 5], False, 500), _e([600, 5], True, 800)], 100),
    "fa_flips": ([_e([10, 5], False, 500), _e([600, 5], False, 800)], 100),
    "fb_flips": ([_e([10, 1000], False, 500)], 100),
    "qlen_fires": ([_e([10, 1000], True, 300)], 50),
    "first_read_flips": ([_e([10, 5], True, 500)], 50),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_chain_ok_on_crafted_chains(case):
    entries, cur = CHAINS[case]
    got = tdist._chain_ok(json.loads(json.dumps(entries)), cur)
    assert got == jdist._chain_ok(entries, cur)
    assert got[0] == (case not in ("fa_flips", "fb_flips",
                                   "first_read_flips"))


@pytest.mark.parametrize("env,nth,cores", [
    (None, 4, 8), (None, 1, 8), (None, 64, 8), (None, 4, 1),
    ("3", 1, 8), ("1", 64, 8), ("0", 4, 8)])
def test_nproc_for(env, nth, cores, monkeypatch):
    """-tN is the worker count, clamped to the cores; the env var
    overrides both ways (as minialign_tpu/cli.py:_nproc_for)."""
    if env is None:
        monkeypatch.delenv("MINIALIGN_PROC_WORKERS", raising=False)
    else:
        monkeypatch.setenv("MINIALIGN_PROC_WORKERS", env)
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    got = tcli._nproc_for(nth)
    assert got == jcli._nproc_for(nth)
    assert got == (max(1, int(env)) if env else max(1, min(nth, cores)))


# ---- the per-host files and the merges


@pytest.mark.parametrize("host", [0, 1])
def test_host_files_equal_jax(host, runs):
    """The port's dist_host files (records and chain sidecar) equal the
    JAX package's run_host files for the same argv, byte for byte; the
    stats sidecar has the same keys."""
    for ext in ("", ".chain"):
        with open(runs["hosts"][host] + ext, "rb") as f, \
                open(runs["jax_hosts"][host] + ext, "rb") as g:
            assert f.read() == g.read(), ext
    with open(runs["hosts"][host] + ".stats") as f, \
            open(runs["jax_hosts"][host] + ".stats") as g:
        assert json.load(f).keys() == json.load(g).keys()


def test_dist_host_pair_merges_to_one_process(runs, on_cpu):
    """The port's merge of the two dist_host processes' files (joined by
    the gloo coordinator) gives the one-process output, @PG included."""
    out, n = merged(tdist, runs["argv"], runs["hosts"])
    assert out == runs["single"]
    assert n >= 1
    assert sum(x.startswith("@PG") for x in out.splitlines()) == 1


@pytest.mark.parametrize("merger", ["jax", "port"])
def test_merge_takes_the_other_packages_files(merger, runs, on_cpu):
    """JAX's merge of the port's files (those of the two dist_host
    processes) and the port's merge of JAX's files both give the port's
    one-process output, remapping the same batches: host 1's batch
    speculated its incoming rlen."""
    mod, paths = (jdist, runs["hosts"]) if merger == "jax" else \
        (tdist, runs["jax_hosts"])
    out, n = merged(mod, runs["argv"], paths)
    assert out == runs["single"]
    assert n >= 1 and n == merged(jdist, runs["argv"], runs["jax_hosts"])[1]


def test_forced_remap_gives_one_process_output(runs, on_cpu):
    """One read's `fired` flipped in the sidecar of the last batch: the
    merge remaps that batch too, under the true chain, and the output is
    still the one-process output."""
    _, n0 = merged(jdist, runs["argv"], runs["hosts"])
    d = runs["dir"] / "remap"
    d.mkdir(exist_ok=True)
    paths = []
    for h, src in enumerate(runs["hosts"]):
        dst = str(d / f"h{h}.out")
        shutil.copy(src, dst)
        with open(src + ".chain") as f:
            lines = [json.loads(line) for line in f]
        for c in lines:
            if c["rank"] == 2:
                e = next(e for e in c["reads"] if e and e["first"])
                e["fired"] = not e["fired"]
        with open(dst + ".chain", "w") as f:
            f.writelines(json.dumps(c) + "\n" for c in lines)
        paths.append(dst)
    out, n = merged(tdist, runs["argv"], paths)
    assert n == n0 + 1
    assert out == runs["single"]


# ---- the CLI's worker processes


def test_cli_workers_byte_identical_to_one_process(runs):
    """MINIALIGN_PROC_WORKERS=2 with the same argv gives the one-process
    output byte for byte, @PG included."""
    assert runs["workers"] == runs["single"]
    assert runs["single"].startswith("@HD")


def test_failed_worker_exits_1(tmp_path):
    """A worker that fails (here: the reads file is missing) makes the
    CLI exit 1 with no output; nothing maps in its place."""
    p = start(["minialign_tpu_torch", "-t1", os.path.join(DATA, "tref.fa"),
               str(tmp_path / "missing.fq")], MINIALIGN_PROC_WORKERS="2")
    out, err = p.communicate(timeout=300)
    assert p.returncode == 1
    assert out == b""
    assert b"worker process failed" in err


def test_tN_spawns_hostworkers(monkeypatch, tmp_path):
    """-t3 on a host with 8 cores starts 3 hostworker processes of the
    port (python -m minialign_tpu_torch.parallel.hostworker), each with
    its rank, the count, its own output file and the argv."""
    calls = []

    class FakeProc:
        def __init__(self, cmd, stdout=None):
            calls.append(cmd)

        def wait(self):
            return 3

    monkeypatch.delenv("MINIALIGN_PROC_WORKERS", raising=False)
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    argv = ["-t3", os.path.join(DATA, "tref.fa"), str(tmp_path / "r.fq")]
    assert tcli.main(argv) == 1          # the fake workers fail
    assert [c[1:5] for c in calls] == [
        ["-m", "minialign_tpu_torch.parallel.hostworker", str(h), "3"]
        for h in range(3)]
    assert all(c[0] == sys.executable and c[6:] == argv for c in calls)
    assert len({c[5] for c in calls}) == 3


def test_cli_starts_workers_without_torch():
    """The CLI module and what its worker branch runs before it starts
    the workers (_prebuild) import no torch, so a -tN parent starts them
    without waiting for it."""
    code = ("import sys; from minialign_tpu_torch import cli; "
            "cli._prebuild(); print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'torch'))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
