"""Port gather (minialign_tpu_torch.dp.cuda_gather.gather_plain) against
the JAX engine's XLA gather (FillEngine._gather_fn) and host slicing,
with circular wrap on and off. Byte-equal rows required."""

import numpy as np
import pytest
import torch

from minialign_tpu.extend import FillEngine as JaxEngine
from minialign_tpu.params import ScoreParams
from minialign_tpu_torch.dp import cuda_gather

NCODE = 4


def _case(seed, wrap):
    rng = np.random.default_rng(seed)
    segs = [int(rng.integers(50, 900)) for _ in range(3)]
    flat = np.concatenate([rng.integers(0, 4, n) for n in segs]).astype(
        np.int8)
    bases = np.cumsum([0] + segs[:-1])
    B, L = 12, 1024
    k = rng.integers(0, 3, B)
    base = bases[k].astype(np.int32)
    seglen = np.asarray(segs, np.int32)[k]
    start = np.asarray([int(rng.integers(0, s + 40)) for s in seglen],
                       np.int32)
    cap = rng.integers(0, 1200, B).astype(np.int32)
    cap[0] = 0                                    # empty row
    start[1] = seglen[1]                          # window at the seg end
    wr = (seglen if wrap else np.zeros(B)).astype(np.int32)
    return flat, base, start, cap, seglen, wr, L


def _host(flat, base, start, cap, seglen, wrap, L):
    out = np.full((len(base), L), NCODE, np.int8)
    for b in range(len(base)):
        for col in range(min(L, cap[b])):
            idx = start[b] + col
            if wrap[b]:
                out[b, col] = flat[base[b] + idx % wrap[b]]
            elif idx < seglen[b]:
                out[b, col] = flat[base[b] + idx]
    return out


@pytest.mark.parametrize("wrap", [False, True])
def test_gather_plain_matches_jax_and_host(wrap):
    flat, base, start, cap, seglen, wr, L = _case(7 + wrap, wrap)
    got = cuda_gather.gather_plain(torch.from_numpy(flat), base, start, cap,
                                   seglen, wr, L).numpy()
    want = np.asarray(JaxEngine(ScoreParams(), use_pallas=False)
                      ._gather_fn(L)(flat, base, start, cap, seglen, wr))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host(flat, base, start, cap,
                                             seglen, wr, L))


def test_gather_dispatch_cpu():
    """gather() on a CPU store is gather_plain."""
    flat, base, start, cap, seglen, wr, L = _case(3, False)
    store = torch.from_numpy(flat)
    assert torch.equal(
        cuda_gather.gather(store, base, start, cap, seglen, wr, L),
        cuda_gather.gather_plain(store, base, start, cap, seglen, wr, L))
