"""P2 in the port (minialign_tpu_torch.probes.lowprec) against
tests/tools/probe_lowprec.py run in Pallas interpret mode: the 5 dtypes
x 6 cases of the tool's main and its step timer in 4 dtypes at 8 and 16
steps; the port's plain twin and its CPU dispatch on the recorded
inputs, exactly. Every value stays at or under 256, so bf16 is exact
either way and no case needs JAX without excess precision."""

import jax.numpy as jnp
import pytest
from test_torch_probes import assert_same, record, tool

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
