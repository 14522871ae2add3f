"""The port's CLI on the CPU against the reference-binary goldens in
tests/data (byte-identical modulo @PG), and its import closure without
jax."""

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


def _run_cli(args, monkeypatch):
    from minialign_tpu_torch import cli
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cpu")
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    assert cli.main(args) == 0
    return out.getvalue()


def _strip_pg(text):
    return [line for line in text.splitlines() if not line.startswith("@PG")]


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
