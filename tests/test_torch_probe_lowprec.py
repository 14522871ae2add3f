"""P2 in the port (minialign_tpu_torch.probes.lowprec) against
tests/tools/probe_lowprec.py run in Pallas interpret mode: the 5 dtypes
x 6 cases of the tool's main and its step timer in 4 dtypes at 8 and 16
steps; the port's plain twin and its CPU dispatch on the recorded
inputs, exactly. Every value of the tool's own inputs stays at or under
256, so bf16 is exact either way.

Then the same 6 cases on edge inputs (kbench.probe_edge_values, handed
to the tool through np.random.randint), at (64, 128) and at an odd size:
int8 and int16 at both ends, int32 at both ends, bf16 and float32 sums
that round. The bf16 cases that round (add, and the +1 of the roll
carry) take their JAX side from a subprocess without excess precision
(test_torch_probes.record_in_subprocess):

    python tests/test_torch_probe_lowprec.py OUT CASE...

records CASEs ("KIND DTYPE CASE", e.g. "odd bfloat16 add") into OUT."""

import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import (assert_same, record, record_in_subprocess,
                               save_calls, tool)

from minialign_tpu_torch import kbench
from minialign_tpu_torch.probes import lowprec

JNP = {"int16": jnp.int16, "int8": jnp.int8, "bfloat16": jnp.bfloat16,
       "float32": jnp.float32, "int32": jnp.int32}
FNS = {
    "add": lambda a, b: a + b,
    "maximum": jnp.maximum,
    "compare-gt": lambda a, b: (a > b),
    "select": lambda a, b: jnp.where(a > b, a, b),
}
CASES = list(lowprec.BINOPS) + ["max-in-carry", "roll-sel-in-carry"]
STEPS = 8


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", lowprec.DTYPES)
def test_case_matches_jax(dtype, case, monkeypatch):
    calls = record(monkeypatch)
    t = tool("probe_lowprec")
    dt = JNP[dtype]
    if case == "max-in-carry":
        t.in_carry(dt, jnp.maximum)
    elif case == "roll-sel-in-carry":
        t.roll_concat(dt)
    else:
        t.elementwise(dt, FNS[case])
    (call,) = calls
    x, y = call.ins
    if case == "max-in-carry":
        plain = lowprec.in_carry_plain("maximum", x, y)
        port = lowprec.in_carry("maximum", x, y, "cpu")
    elif case == "roll-sel-in-carry":
        plain = lowprec.roll_concat_plain(x, y)
        port = lowprec.roll_concat(x, y, "cpu")
    else:
        plain = lowprec.elementwise_plain(case, x, y)
        port = lowprec.elementwise(case, x, y, "cpu")
    assert_same(plain, call.out)
    assert_same(port, call.out)


@pytest.mark.parametrize("dtype", lowprec.STEP_DTYPES)
def test_step_timer_matches_jax(dtype, monkeypatch):
    """The tool times 6 runs at n steps, then 6 at 2 n, each pair of
    inputs drawn anew: calls 0 and 6 are one of each."""
    calls = record(monkeypatch)
    tool("probe_lowprec").step_timer(JNP[dtype], 64, 128, STEPS)
    assert len(calls) == 12
    for call, n in ((calls[0], STEPS), (calls[6], 2 * STEPS)):
        x, dd = call.ins
        assert_same(lowprec.step_timer_plain(x, dd, n), call.out)
        assert_same(lowprec.step_loop(x, dd, n, "cpu"), call.out)
    timed = lowprec.step_timer(*calls[0].ins, STEPS, "cpu", reps=1)
    assert_same(timed.out, calls[0].out)


EDGE_KINDS = ("extreme", "odd")
ROUNDING = ("add", "roll-sel-in-carry")    # bf16 cases whose sums round


def run_edge_case(case: str) -> None:
    """The tool's case "KIND DTYPE CASE" on kbench.probe_edge_values at
    (64, 128) ("extreme") or kbench.PROBE_ODD_SHAPE ("odd"), drawn from a
    seed of the case's name."""
    kind, dtype, name = case.split(" ", 2)
    shape = kbench.PROBE_ODD_SHAPE if kind == "odd" else (64, 128)
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    arrays = iter([kbench.probe_edge_values(rng, dtype, shape)
                   for _ in range(2)])
    t = tool("probe_lowprec")
    dt = JNP[dtype]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np.random, "randint", lambda lo, hi, size: next(arrays))
        if name == "max-in-carry":
            t.in_carry(dt, jnp.maximum, shape)
        elif name == "roll-sel-in-carry":
            t.roll_concat(dt, shape)
        else:
            t.elementwise(dt, FNS[name], shape)


def port_case(name: str, x, y):
    if name == "max-in-carry":
        return lowprec.in_carry("maximum", x, y, "cpu")
    if name == "roll-sel-in-carry":
        return lowprec.roll_concat(x, y, "cpu")
    return lowprec.elementwise(name, x, y, "cpu")


@pytest.fixture(scope="module")
def exact_bf16_edges(tmp_path_factory):
    return record_in_subprocess(
        __file__, [f"{k} bfloat16 {c}" for k in EDGE_KINDS for c in ROUNDING],
        tmp_path_factory.mktemp("edges"))


def edge_call(kind, dtype, name, monkeypatch, request):
    case = f"{kind} {dtype} {name}"
    if dtype == "bfloat16" and name in ROUNDING:
        (call,) = request.getfixturevalue("exact_bf16_edges")[case]
        return call
    calls = record(monkeypatch)
    run_edge_case(case)
    (call,) = calls
    return call


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", lowprec.DTYPES)
def test_case_on_edge_inputs_matches_jax(dtype, case, monkeypatch, request):
    call = edge_call("extreme", dtype, case, monkeypatch, request)
    x, y = call.ins
    lo, hi = kbench.PROBE_EDGE_RANGES[dtype][1]
    assert bool((x.double() >= lo - 1).any())        # the edge values
    assert_same(port_case(case, x, y), call.out)


@pytest.mark.parametrize("dtype", lowprec.DTYPES)
def test_cases_at_an_odd_size_match_jax(dtype, monkeypatch, request):
    for case in CASES:
        call = edge_call("odd", dtype, case, monkeypatch, request)
        x, y = call.ins
        assert x.shape == kbench.PROBE_ODD_SHAPE
        assert_same(port_case(case, x, y), call.out)


def test_bf16_edge_sums_round_in_both():
    """Why the rounding bf16 cases go to the subprocess: their sums are
    not bf16 values, so the port's per-op rounding shows."""
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(kbench.probe_edge_values(
        rng, "bfloat16", (64, 128)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    exact = x.float() + y.float()
    assert bool((lowprec.elementwise("add", x, y, "cpu") != exact).any())


if __name__ == "__main__":
    save_calls(sys.argv[1], run_edge_case, sys.argv[2:])
