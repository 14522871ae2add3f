"""P1 in the port (minialign_tpu_torch.probes.subint32) against
tests/tools/probe_subint32.py run in Pallas interpret mode: every case
of the tool's main, the port's plain twin and its CPU dispatch on the
recorded inputs, exactly."""

import jax.numpy as jnp
import pytest
import torch
from test_torch_probes import assert_same, record, tool

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
