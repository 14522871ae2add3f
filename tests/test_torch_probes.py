"""What the four probe test files share, and the tests of the probes'
entry point.

`record(monkeypatch)` runs a JAX tool of tests/tools/ as its own tests
would on a CPU: pl.pallas_call in interpret mode, recording each call's
kernel, inputs and output (as torch tensors, bf16 exactly); jax.jit as
the identity, so outputs are concrete; pltpu.roll with its shift taken
modulo the axis size (this JAX refuses the tools' shift of -1, which
means row r <- row r + 1, np.roll(x, -1, 0)). The port's plain twins
then get the recorded inputs and must give the recorded output exactly.

On the CPU, XLA keeps bf16 intermediates in float32. A bf16 case whose
values pass 256 (not exact in bf16) therefore takes its JAX side from a
subprocess run with --xla_allow_excess_precision=false, which rounds
after each op as torch does: `record_in_subprocess`.
"""

import importlib.util
import io
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tests", "tools")
_real_pallas_call = pl.pallas_call
_real_roll = pltpu.roll


class Call(NamedTuple):
    kernel: object
    out_shape: object
    ins: tuple
    out: torch.Tensor


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def tool(name: str):
    """tests/tools/<name>.py, imported once."""
    key = f"_tool_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(TOOLS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def record(monkeypatch) -> list:
    """Patch JAX as the module docstring says; returns the list that
    each pallas_call appends its Call to."""
    calls = []

    def pallas_call(kernel, **kw):
        f = _real_pallas_call(kernel, interpret=True, **kw)

        def run(*args):
            out = f(*args)
            calls.append(Call(kernel, kw.get("out_shape"),
                              tuple(to_torch(a) for a in args),
                              to_torch(out)))
            return out
        return run

    def roll(x, shift, axis):
        return _real_roll(x, shift % x.shape[axis], axis)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    monkeypatch.setattr(pltpu, "roll", roll)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    return calls


def rerun(call: Call, *args):
    """The recorded kernel body on other inputs (interpret mode), with
    the out_shape of the first input's shape."""
    shape = jax.ShapeDtypeStruct(np.shape(args[0]), call.out_shape.dtype)
    return np.asarray(_real_pallas_call(call.kernel, out_shape=shape,
                                        interpret=True)(*args))


def assert_same(got: torch.Tensor, want: torch.Tensor):
    """Exactly equal, dtype and shape included."""
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    g, w = got.to(torch.float64), want.to(torch.float64)
    bad = g != w
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {g.numel()} differ; got {g[bad][:4].tolist()}"
        f" want {w[bad][:4].tolist()}")


def record_in_subprocess(test_file: str, cases, tmp_path) -> dict:
    """Run `python <test_file> <out> <case>...` with excess precision off
    and return its {case: [Call without kernel, ...]}: the file's
    __main__ block runs each case under record() and saves the calls."""
    out = tmp_path / "calls.pt"
    path = os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_allow_excess_precision=false").strip())
    r = subprocess.run([sys.executable, test_file, str(out), *cases],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return {case: [Call(None, None, tuple(ins), o) for ins, o in calls]
            for case, calls in torch.load(out, weights_only=True).items()}


def save_calls(path: str, run_case, cases) -> None:
    """For a test file's __main__: record each case and save the inputs
    and outputs (torch.save) to path."""
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        for case in cases:
            calls = record(mp)
            run_case(case)
            res[case] = [(list(c.ins), c.out) for c in calls]
    torch.save(res, path)


# ---- the probes' entry point


def test_probes_cli_raises_without_cuda():
    """The default device is cuda, and asking for it without a card is an
    error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "-m", "minialign_tpu_torch.probes",
                        "--device", "cuda"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert "OK" not in r.stdout


def test_probes_cli_on_cpu_never_imports_jax():
    """All four probes on the CPU (the loops at CPU_STEPS): exit 0, every
    case OK, the div-by-10 finding reported, and jax never imported; no
    module under probes/ names jax."""
    code = ("import sys\n"
            "from minialign_tpu_torch.probes.__main__ import main\n"
            "rc = main(['--device', 'cpu'])\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    oks = [x for x in lines if x.startswith("  OK   ")]
    assert len(oks) == 18 + 30 + 10 + 3, len(oks)   # P1, P2, P3, P4
    assert sum("FAIL div-by-10 magic == x // 10" in x for x in lines) == 1
    assert sum("ns/step" in x for x in lines) == 4 + 3 + 1
    assert lines[-1] == "device time: not measured (plain torch on the CPU)"
    pkg = os.path.join(ROOT, "minialign_tpu_torch", "probes")
    for f in os.listdir(pkg):
        if f.endswith(".py"):
            with open(os.path.join(pkg, f)) as fh:
                src = fh.read()
            assert "import jax" not in src and "from jax" not in src, f


def test_report_times_run_and_library_alike():
    """A Report's comparison calls the kernel's run() exactly as often as
    the one PyTorch call: one warm-up, then a window of WINDOW calls
    each (here on the CPU, on the host clock, and no device time: it is
    "not measured", never a number)."""
    from minialign_tpu_torch.probes._common import Report
    rep = Report(device="cpu", out=io.StringIO())
    n = {"run": 0, "library": 0}
    x = torch.arange(8, dtype=torch.int32)

    def run():
        n["run"] += 1
        return x + x

    def library():
        n["library"] += 1
        return torch.add(x, x)

    got, ok, times = rep._compare("p1", run, lambda: x + x, ((x, x), 1),
                                  library)
    assert ok and torch.equal(got, x + x)
    assert n["run"] == n["library"] == Report.WINDOW + 1
    st = rep.stats["p1"]
    assert st["library_cases"] == 1
    assert st["library_kernel_ms"] == times.host_ms
    assert times.device_ms is None and times.library_device_ms is None
    assert st["device_ms"] is None and st["library_device_ms"] is None
    assert "kernel not measured device" in times.line()
    rep.summary()
    assert "not measured" in rep.out.getvalue()


def test_report_sums_the_bound_over_the_library_cases():
    """library_bound_ms sums the bound of the cases that have a PyTorch
    call and only of those, as library_kernel_device_ms sums their
    device time, so that the two cover the same cases; bound_ms sums
    every compared case."""
    from minialign_tpu_torch.probes._common import Report, bound_ms
    rep = Report(device="cpu", out=io.StringIO())
    x = torch.arange(64, dtype=torch.int32)
    y = torch.arange(256, dtype=torch.int32)
    rep._compare("p3", lambda: x + x, lambda: x + x, ((x, x), 2),
                 lambda: torch.add(x, x))
    rep._compare("p3", lambda: y * 2, lambda: y * 2, ((y,), 7))
    st = rep.stats["p3"]
    one = max(bound_ms(3 * 64 * 4, 64 * 2))
    other = max(bound_ms(2 * 256 * 4, 256 * 7))
    assert st["library_cases"] == 1 and st["compared"] == 2
    assert st["library_bound_ms"] == pytest.approx(one, rel=1e-12)
    assert st["bound_ms"] == pytest.approx(one + other, rel=1e-12)


def test_kbench_probe_cases_carry_their_work():
    """kbench.probe_cases gives every one-call case its work as the
    probes' mains give it (inputs, operations per element), so that
    kbench --probes sums the bound over the cases it times; the cases
    with a PyTorch call are P1's 12, P2's 20 and P3's 4."""
    from minialign_tpu_torch import kbench
    from minialign_tpu_torch.probes._common import bound_ms
    cases = kbench.probe_cases(torch.device("cpu"),
                               np.random.default_rng(0))
    n_lib = {}
    for probe, name, run, library, plain, (ins, ops) in cases:
        assert all(isinstance(t, torch.Tensor) for t in ins) and ops >= 1
        out = plain()
        assert max(bound_ms(sum(t.numel() * t.element_size() for t in ins)
                            + out.numel() * out.element_size(),
                            out.numel() * ops)) > 0
        n_lib[probe] = n_lib.get(probe, 0) + (library is not None)
    assert n_lib == {"p1": 12, "p2": 20, "p3": 4, "p4": 0}
