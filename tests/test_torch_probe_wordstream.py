"""P4 in the port (minialign_tpu_torch.probes.wordstream) against
tests/tools/probe_wordstream.py run in Pallas interpret mode: its three
primitives and its stream timing loop at 8 and 16 steps; the port's
plain twin and its CPU dispatch on the recorded inputs, exactly.

The tool's pltpu.roll(x, -1, axis=0) runs with its shift taken modulo
the axis size (test_torch_probes.record). Its div10_magic check fails on
its own inputs: ((x >> 1) * 52429) >> 18 wraps in int32 from x = 81,920
on, and the tool draws x from [0, 2^18). The port computes the same
wrapped values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from test_torch_probes import assert_same, record, rerun, tool

from minialign_tpu_torch.probes import wordstream

STEPS = 8


def test_roll_shift_7_is_numpy_roll_minus_1():
    """pltpu.roll(x, 7, 0) on 8 rows, in interpret mode, is
    np.roll(x, -1, 0): row r <- row r + 1 (mod 8)."""
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)

    def kernel(x_ref, o_ref):
        o_ref[:] = pltpu.roll(x_ref[:], 7, 0)
    got = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(
        x.shape, jnp.int32), interpret=True)(x)
    np.testing.assert_array_equal(np.asarray(got), np.roll(x, -1, 0))
    assert_same(wordstream._roll(torch.from_numpy(x)),
                torch.from_numpy(np.roll(x, -1, 0)))


@pytest.mark.parametrize("case", ["var_shift", "roll_in_carry",
                                  "div10_magic"])
def test_primitive_matches_jax(case, monkeypatch):
    calls = record(monkeypatch)
    fn = getattr(tool("probe_wordstream"), case)
    if case == "div10_magic":
        with pytest.raises(AssertionError):   # the tool's own check
            fn()
    else:
        fn()
    (call,) = calls
    plain = getattr(wordstream, f"{case}_plain")(*call.ins)
    port = getattr(wordstream, case)(*call.ins, device="cpu")
    assert_same(plain, call.out)
    assert_same(port, call.out)
    if case == "div10_magic":
        (x,) = call.ins
        assert wordstream.div10_check(x, port) is not None


def test_div10_whole_range_matches_jax(monkeypatch):
    """The tool's div10 kernel on every x in [0, 2^18): the port gives
    the same int32 values, wrapped ones included; they equal x // 10
    exactly below 81,920."""
    calls = record(monkeypatch)
    with pytest.raises(AssertionError):
        tool("probe_wordstream").div10_magic()
    x = np.arange(2**18, dtype=np.int32).reshape(-1, 128)
    want = rerun(calls[0], x)
    got = wordstream.div10_magic(x, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    flat = x.ravel()
    wrong = flat[got.ravel() != flat // 10]
    assert wrong.min() == 81_920
    assert len(wrong) == 180_224


def test_stream_timing_matches_jax(monkeypatch):
    """The tool runs the loop once to warm up and 4 times timed."""
    calls = record(monkeypatch)
    t = tool("probe_wordstream")
    t.stream_timing(STEPS)
    t.stream_timing(2 * STEPS)
    assert len(calls) == 10
    for call, n in ((calls[0], STEPS), (calls[5], 2 * STEPS)):
        assert_same(wordstream.stream_timing_plain(*call.ins, n), call.out)
        assert_same(wordstream.stream_loop(*call.ins, n, "cpu"), call.out)
    timed = wordstream.stream_timing(*calls[0].ins, STEPS, "cpu", reps=1)
    assert_same(timed.out, calls[0].out)
