"""The port's CLI on the CPU against the reference-binary goldens in
tests/data (byte-identical modulo @PG), and its import closure without
jax. run_golden is the golden suite's runner
(tests/test_torch_golden_*.py)."""

import io
import os
import subprocess
import sys

import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain CPU path runs thousands of tiny ops, which gain nothing
    from intra-op threads; with several pytest workers on the machine
    those threads only contend (a golden took 7x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cli_run(args):
    """The port's CLI in this process: (stdout, exit code)."""
    import contextlib

    from minialign_tpu_torch import cli
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main(args)
    return out.getvalue(), rc


def _run_cli(args, monkeypatch):
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cpu")
    out, rc = cli_run(args)
    assert rc == 0
    return out


def _strip_pg(text):
    return [line for line in text.splitlines() if not line.startswith("@PG")]


def run_golden(name, monkeypatch, tmp_path, duo="1"):
    """chip_smoke.GOLDENS's case `name` through the port's CLI on the
    CPU with MINIALIGN_DUO=duo, compared with its golden as
    tests/test_golden_sam.py compares it; the engine's duo batches
    counted (some, duo on and a linear reference; none, duo off). A -tN
    case maps in min(N, cores) worker processes (one torch thread each),
    which are counted instead: their duo batches are theirs. Returns the
    output."""
    import chip_smoke
    from minialign_tpu_torch import cli
    from minialign_tpu_torch.extend import FillEngine
    _, args, golden, mode, _, pre = {g[0]: g for g in chip_smoke.GOLDENS}[
        name]
    monkeypatch.setenv("MINIALIGN_DUO", duo)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("MINIALIGN_PROC_WORKERS", raising=False)
    batches, procs = [], []
    duo_batch = FillEngine._duo_batch
    align_procs = cli._align_procs

    def counted(self, reqs, W):
        batches.append(len(reqs))
        return duo_batch(self, reqs, W)

    def counted_procs(o, log, argv, nproc):
        procs.append(nproc)
        return align_procs(o, log, argv, nproc)
    monkeypatch.setattr(FillEngine, "_duo_batch", counted)
    monkeypatch.setattr(cli, "_align_procs", counted_procs)
    if pre:
        _run_cli(chip_smoke.golden_args(pre, DATA, str(tmp_path)),
                 monkeypatch)
    got = _run_cli(chip_smoke.golden_args(args, DATA, str(tmp_path)),
                   monkeypatch)
    with open(f"{DATA}/{golden}") as f:
        want = f.read()
    assert chip_smoke.golden_view(got, mode) == \
        chip_smoke.golden_view(want, mode)
    nth = int(next((a[2:] for a in args if a.startswith("-t")), "1"))
    nproc = min(nth, os.cpu_count() or 1)
    assert procs == ([nproc] if nproc > 1 else [])
    if duo != "1" or procs:
        assert not batches
    elif not any(a.startswith("-c") for a in args):
        assert batches
    return got


def run_input(name, monkeypatch, tmp_path, device="cpu"):
    """chip_smoke.QUERY_INPUTS's case `name` through the port's CLI in
    this process on `device`, its query from stdin (plain or gzipped) or
    a gzipped file, held to ref_out.sam without @PG. Stdin maps in
    process (through the threaded source/drain pipeline at -t2), a path
    at -t2 in min(2, cores) worker processes, which are counted. Returns
    the output."""
    import chip_smoke
    from minialign_tpu_torch import cli
    _, args, src = {q[0]: q for q in chip_smoke.QUERY_INPUTS}[name]
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", device)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("MINIALIGN_PROC_WORKERS", raising=False)
    procs = []
    align_procs = cli._align_procs

    def counted_procs(o, log, argv, nproc):
        procs.append(nproc)
        return align_procs(o, log, argv, nproc)
    monkeypatch.setattr(cli, "_align_procs", counted_procs)
    stdin = chip_smoke.query_input(src, str(tmp_path))
    got = chip_smoke.run_cli(cli, chip_smoke.golden_args(
        args, DATA, str(tmp_path)), stdin=stdin)
    with open(f"{DATA}/ref_out.sam") as f:
        want = f.read()
    assert chip_smoke.golden_view(got, "pg") == \
        chip_smoke.golden_view(want, "pg")
    nproc = min(int(args[0][2:]), os.cpu_count() or 1)
    assert procs == ([nproc] if stdin is None and nproc > 1 else [])
    return got


@pytest.mark.parametrize("args,golden", [
    (["-t1"], "ref_out.sam"),
    (["-t1", "-xpacbio"], "ref_pacbio.sam"),
])
def test_cli_cpu_byte_identical(args, golden, monkeypatch):
    got = _run_cli(args + [f"{DATA}/tref.fa", f"{DATA}/treads.fq"],
                   monkeypatch)
    with open(f"{DATA}/{golden}") as f:
        want = f.read()
    assert _strip_pg(got) == _strip_pg(want)


def test_cli_without_jax():
    """The port's CLI imports and maps with `jax` unimportable."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "from minialign_tpu_torch import cli\n"
            "sys.exit(cli.main(['-t1', sys.argv[1], sys.argv[2]]))\n")
    env = dict(os.environ, MINIALIGN_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("MINIALIGN_PLATFORM", None)
    r = subprocess.run([sys.executable, "-c", code, f"{DATA}/tref.fa",
                        f"{DATA}/treads2.fq"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    recs = [line for line in r.stdout.splitlines()
            if not line.startswith("@")]
    assert len(recs) >= 6 and all(line.split("\t")[2] == "chr_t"
                                  for line in recs)


def test_cli_cuda_device_raises_without_cuda(monkeypatch):
    """Asking for CUDA where there is none is an error, not a fall-back
    to the CPU."""
    from minialign_tpu_torch import cli
    from minialign_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-t1", f"{DATA}/tref.fa", f"{DATA}/treads.fq"])
    assert resolve_device("cpu").type == "cpu"
