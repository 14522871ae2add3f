"""The port's device sketch, plain version
(minialign_tpu_torch.index.sketch_device.sketch_device_plain and
sketch_device on a CPU tensor), against the JAX package's sketch_device
(minialign_tpu/index/sketch_jax.py:39) on the CPU: the four arrays over
every k-mer position (hash, pos, strand, emit) exactly equal, at every
(k, w) of kbench's edge list, on seeded numpy codes that hold every
SKETCH_KINDS kind (N, all A, an AT run, palindromes at even k), and at
the shortest lengths that have a position. The JAX function returns
hash and strand as uint32, the port hash as uint32 and strand as uint8:
values are compared."""

import numpy as np
import pytest
import torch

from minialign_tpu.index.sketch_jax import sketch_device as jax_sketch
from minialign_tpu_torch import kbench
from minialign_tpu_torch.index.sketch_device import (sketch_device,
                                                     sketch_device_plain)


def mixed_codes(k, w, L=None):
    """Codes of length L (seeded, 30-1,200 when not given), one segment
    of each SKETCH_KINDS kind."""
    rng = np.random.default_rng(1000 * k + w)
    L = int(rng.integers(30, 1201)) if L is None else L
    cut = np.sort(rng.integers(0, L + 1, len(kbench.SKETCH_KINDS) - 1))
    sizes = np.diff(np.concatenate([[0], cut, [L]]))
    return np.concatenate([kbench.sketch_codes(rng, kind, int(m), k)
                           for kind, m in zip(kbench.SKETCH_KINDS, sizes)])


def assert_same(got, want):
    assert len(got) == len(want) == 4
    for name, g, x in zip(("hash", "pos", "strand", "emit"), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        x = np.asarray(x)
        assert g.shape == x.shape, name
        np.testing.assert_array_equal(g.astype(np.int64), x.astype(np.int64),
                                      err_msg=name)


@pytest.mark.parametrize("w", kbench.SKETCH_W)
@pytest.mark.parametrize("k", kbench.SKETCH_K)
def test_sketch_device_plain_matches_jax(k, w):
    codes = mixed_codes(k, w)
    want = jax_sketch(codes, k, w)
    got = sketch_device(torch.from_numpy(codes), k, w)
    assert got[0].dtype == torch.uint32 and got[1].dtype == torch.int32
    assert got[3].dtype == torch.bool
    assert_same(got, want)
    # the plain version's int32 words hold the same bits
    h = sketch_device_plain(torch.from_numpy(codes), k, w)[0]
    np.testing.assert_array_equal(h.numpy().view(np.uint32),
                                  np.asarray(want[0]))


@pytest.mark.parametrize("w", (1, 3, 16))
@pytest.mark.parametrize("k", kbench.SKETCH_K)
def test_sketch_device_plain_matches_jax_at_short_lengths(k, w):
    """One k-mer, two, the first full window and one past it."""
    for L in sorted({k, k + 1, k + w - 1, k + w}):
        codes = mixed_codes(k, w, L)
        assert_same(sketch_device(torch.from_numpy(codes), k, w),
                    jax_sketch(codes, k, w))
