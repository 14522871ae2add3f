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


def _run_cli(args, monkeypatch):
    from minialign_tpu_torch import cli
    monkeypatch.setenv("MINIALIGN_TORCH_DEVICE", "cpu")
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    assert cli.main(args) == 0
    return out.getvalue()


def _strip_pg(text):
    return [line for line in text.splitlines() if not line.startswith("@PG")]


def run_golden(name, monkeypatch, tmp_path, duo="1"):
    """chip_smoke.GOLDENS's case `name` through the port's CLI on the
    CPU with MINIALIGN_DUO=duo, compared with its golden as
    tests/test_golden_sam.py compares it; the engine's duo batches
    counted (some, duo on and a linear reference; none, duo off).
    Returns the output."""
    import chip_smoke
    from minialign_tpu_torch.extend import FillEngine
    _, args, golden, mode, _, pre = {g[0]: g for g in chip_smoke.GOLDENS}[
        name]
    monkeypatch.setenv("MINIALIGN_DUO", duo)
    batches = []
    duo_batch = FillEngine._duo_batch

    def counted(self, reqs, W):
        batches.append(len(reqs))
        return duo_batch(self, reqs, W)
    monkeypatch.setattr(FillEngine, "_duo_batch", counted)
    if pre:
        _run_cli(chip_smoke.golden_args(pre, DATA, str(tmp_path)),
                 monkeypatch)
    got = _run_cli(chip_smoke.golden_args(args, DATA, str(tmp_path)),
                   monkeypatch)
    with open(f"{DATA}/{golden}") as f:
        want = f.read()
    assert chip_smoke.golden_view(got, mode) == \
        chip_smoke.golden_view(want, mode)
    if duo != "1":
        assert not batches
    elif not any(a.startswith("-c") for a in args):
        assert batches
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
