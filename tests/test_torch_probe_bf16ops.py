"""P3 in the port (minialign_tpu_torch.probes.bf16ops) against
tests/tools/probe_bf16ops.py run in Pallas interpret mode: the 10
building blocks of the tool's main and its timing loop in 3 dtypes at 8
and 16 steps; the port's plain twin and its CPU dispatch on the
recorded inputs, exactly.

The products of two values from [0, 60) pass 256, where bf16 is not
exact: the multiply and the broadcast-row multiply take their JAX side
from a subprocess without excess precision (test_torch_probes.py). The
timing loop's values stay within its inputs' [0, 5).

    python tests/test_torch_probe_bf16ops.py OUT CASE...

records CASEs (keys of CASES) into OUT, for that subprocess.
"""

import sys

import jax.numpy as jnp
import pytest
import torch
from test_torch_probes import (assert_same, record, record_in_subprocess,
                               save_calls, tool)

from minialign_tpu_torch.probes import bf16ops

bf = jnp.bfloat16
# the tool's main: op -> (lambda, input dtype), as probe_bf16ops.py has them
CASES = {
    "multiply": (lambda a, b: a * b, bf),
    "sub": (lambda a, b: a - b, bf),
    "concat-roll": (lambda a, b: jnp.concatenate(
        [a[1:], jnp.zeros((1, 128), bf)], axis=0) + b, bf),
    "arith-eq-mask": (lambda a, b: jnp.maximum(
        1 - (jnp.maximum(a, b) - b), jnp.zeros((), bf)), bf),
    "arith-select": (lambda a, b: a + jnp.maximum(
        1 - (jnp.maximum(a, b) - b), jnp.zeros((), bf)) * (b - a), bf),
    "min": (jnp.minimum, bf),
    "broadcast-row-mul": (lambda a, b: a * b[0:1], bf),
    "bf16->int32": (lambda a, b: (a + b).astype(jnp.int32).astype(
        jnp.float32), bf),
    "int32->bf16": (lambda a, b: (a + b).astype(jnp.bfloat16), jnp.int32),
    "int16-store-int32-compute": (lambda a, b: (
        a.astype(jnp.int32) + b.astype(jnp.int32)).astype(jnp.int16).astype(
            jnp.float32), jnp.int16),
}
PAST_256 = ("multiply", "broadcast-row-mul")
TIMING = {"int32": jnp.int32, "float32": jnp.float32, "bfloat16": bf}
STEPS = 8


def run_case(op):
    fn, dt = CASES[op]
    tool("probe_bf16ops").run2(fn, dt)


@pytest.fixture(scope="module")
def exact_bf16(tmp_path_factory):
    """The PAST_256 cases recorded without excess precision."""
    return record_in_subprocess(__file__, PAST_256,
                                tmp_path_factory.mktemp("bf16"))


def test_case_list_is_the_ports():
    assert tuple(CASES) == bf16ops.OP_NAMES


@pytest.mark.parametrize("op", list(CASES))
def test_run2_matches_jax(op, monkeypatch, request):
    if op in PAST_256:
        (call,) = request.getfixturevalue("exact_bf16")[op]
    else:
        calls = record(monkeypatch)
        run_case(op)
        (call,) = calls
    x, y = call.ins
    assert str(x.dtype) == "torch." + {o: d for o, _, d in bf16ops.OPS}[op]
    assert_same(bf16ops.run2_plain(op, x, y), call.out)
    assert_same(bf16ops.run2(op, x, y, "cpu"), call.out)


def test_multiply_in_process_keeps_excess_precision(monkeypatch):
    """Why PAST_256 goes to a subprocess: in this process, XLA on the CPU
    returns the exact product, not the bf16-rounded one."""
    calls = record(monkeypatch)
    run_case("multiply")
    (call,) = calls
    x, y = call.ins
    exact = x.float() * y.float()
    assert torch.equal(call.out, exact)
    rounded = bf16ops.run2_plain("multiply", x, y)
    assert bool((rounded != exact).any())
    assert torch.equal(rounded, exact.to(torch.bfloat16).float())


@pytest.mark.parametrize("dtype", list(TIMING))
def test_timing_matches_jax(dtype, monkeypatch):
    """The tool runs the loop once to warm up and 4 times timed."""
    calls = record(monkeypatch)
    t = tool("probe_bf16ops")
    t.timing(TIMING[dtype], 6, STEPS)
    t.timing(TIMING[dtype], 6, 2 * STEPS)
    assert len(calls) == 10
    for call, n in ((calls[0], STEPS), (calls[5], 2 * STEPS)):
        (x,) = call.ins
        assert_same(bf16ops.timing_plain(x, n), call.out)
        assert_same(bf16ops.timing_loop(x, n, "cpu"), call.out)
    timed = bf16ops.timing(*calls[0].ins, STEPS, "cpu", reps=1)
    assert_same(timed.out, calls[0].out)


if __name__ == "__main__":
    save_calls(sys.argv[1], run_case, sys.argv[2:])
