"""P1 in the port (minialign_tpu_torch.probes.subint32) against
tests/tools/probe_subint32.py run in Pallas interpret mode: every case
of the tool's main, the port's plain twin and its CPU dispatch on the
recorded inputs, exactly; then the same cases on edge inputs
(kbench.probe_edge_values, handed to the tool through
np.random.randint) and at an odd size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import assert_same, record, rerun, to_torch, tool

from minialign_tpu_torch import kbench
from minialign_tpu_torch.probes import subint32

JNP = {"int16": jnp.int16, "int8": jnp.int8, "uint8": jnp.uint8}
# the tool's lambdas, by the port's op names
FNS = {
    "add": lambda a, b: a + b,
    "maximum": jnp.maximum,
    "compare-gt": lambda a, b: a > b,
    "select": lambda a, b: jnp.where(a > b, a, b),
}
CASES = [(op, False) for op in subint32.BINOPS] + \
    [(op, True) for op in subint32.CARRY_OPS]


@pytest.mark.parametrize("op,carry", CASES)
@pytest.mark.parametrize("dtype", subint32.DTYPES)
def test_probe_matches_jax(dtype, op, carry, monkeypatch):
    calls = record(monkeypatch)
    t = tool("probe_subint32")
    fn = t.probe_carry if carry else t.probe
    assert fn(f"{dtype} {op}", JNP[dtype], FNS[op])
    (call,) = calls
    x, y = call.ins
    assert x.dtype == getattr(torch, dtype)
    if carry:
        plain = subint32.probe_carry_plain(op, x, y)
        port = subint32.probe_carry(op, x, y, "cpu")
    else:
        plain = subint32.probe_plain(op, x, y)
        port = subint32.probe(op, x, y, "cpu")
    assert_same(plain, call.out)
    assert_same(port, call.out)


def edge_arrays(dtype, shape, seed):
    """Two arrays of kbench.probe_edge_values (int16 at +-32,767, uint8
    on both sides of 128), as numpy draws them for the tool."""
    rng = np.random.default_rng(seed)
    return [kbench.probe_edge_values(rng, dtype, shape) for _ in range(2)]


def draw_from(monkeypatch, arrays):
    """np.random.randint returns `arrays` in turn: the tool's inputs."""
    it = iter(arrays)
    monkeypatch.setattr(np.random, "randint", lambda lo, hi, size: next(it))


@pytest.mark.parametrize("op,carry", CASES)
@pytest.mark.parametrize("dtype", subint32.DTYPES)
def test_probe_on_edge_inputs_matches_jax(dtype, op, carry, monkeypatch):
    """The tool's kernel on values at the type's edges: every op wraps
    per lane and uint8 compares unsigned, in JAX as in the port."""
    calls = record(monkeypatch)
    arrays = edge_arrays(dtype, (64, 128), 5)
    draw_from(monkeypatch, arrays)
    t = tool("probe_subint32")
    assert (t.probe_carry if carry else t.probe)(
        f"{dtype} {op}", JNP[dtype], FNS[op])
    (call,) = calls
    x, y = call.ins
    assert torch.equal(x, torch.from_numpy(arrays[0].astype(dtype)))
    want = call.out
    if carry:
        assert_same(subint32.probe_carry(op, x, y, "cpu"), want)
    else:
        assert_same(subint32.probe(op, x, y, "cpu"), want)


@pytest.mark.parametrize("dtype", subint32.DTYPES)
def test_probe_at_an_odd_size_matches_jax(dtype, monkeypatch):
    """Each of the tool's kernel bodies on edge values of shape
    kbench.PROBE_ODD_SHAPE (259 values, no multiple of 16), run again in
    interpret mode with its out_shape at that shape."""
    calls = record(monkeypatch)
    t = tool("probe_subint32")
    for op, carry in CASES:
        (t.probe_carry if carry else t.probe)(op, JNP[dtype], FNS[op])
    x, y = (a.astype(np.dtype(dtype)) for a in edge_arrays(
        dtype, kbench.PROBE_ODD_SHAPE, 6))
    for (op, carry), call in zip(CASES, calls):
        want = to_torch(rerun(call, x, y))
        fn = subint32.probe_carry if carry else subint32.probe
        assert_same(fn(op, torch.from_numpy(x), torch.from_numpy(y), "cpu"),
                    want)
