"""The identity the device sketch's kernel (csrc/sketch.cu) rests on, on
the CPU: for every 32-bit word kx, _mm_crc32_u64(kx, kx) is 0, so the
hash (crc32c(kx) ^ km) & (4^k - 1) of a k-mer with k <= 16 is km, its
canonical k-mer. Held for the JAX package's _crc32c_u32pair, the port's
plain version's (index/sketch_device._crc32c_u32pair) and the host
sketch's crc32c_u64 (index/sketch.py), on seeded random words and the
edge words (0, 2^32 - 1, every 4^k - 1, every single bit); and on the
sketch itself: sketch_device_plain's hash is min(k0, k1) at the
position it reports. Also the plain version against the JAX function at
windows past 128, where the window index and the strand bit overlap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minialign_tpu.index.sketch_jax import _crc32c_u32pair as jax_crc
from minialign_tpu.index.sketch_jax import sketch_device as jax_sketch
from minialign_tpu_torch import kbench
from minialign_tpu_torch.index import sketch as tsketch
from minialign_tpu_torch.index import sketch_device as sd
from test_torch_sketch import assert_same, mixed_codes


def crc_words():
    """2^16 seeded random 32-bit words, then 0, 2^32 - 1, 4^k - 1 for
    k = 1..16 and 2^b for b = 0..31."""
    rng = np.random.default_rng(2024)
    edge = [0, 0xFFFFFFFF] + [(1 << (2 * k)) - 1 for k in range(1, 17)] \
        + [1 << b for b in range(32)]
    return np.concatenate([rng.integers(0, 1 << 32, 1 << 16, np.uint64),
                           np.array(edge, np.uint64)])


CRC = {
    "jax": lambda kx: np.asarray(jax_crc(jnp.asarray(kx, jnp.uint32),
                                         jnp.zeros(len(kx), jnp.uint32))),
    "port_plain": lambda kx: sd._crc32c_u32pair(
        torch.from_numpy(kx.astype(np.int64))).numpy(),
    "host": lambda kx: tsketch.crc32c_u64(kx, kx),
}


@pytest.mark.parametrize("impl", sorted(CRC))
def test_crc_of_a_word_with_itself_is_zero(impl):
    kx = crc_words()
    got = np.asarray(CRC[impl](kx)).astype(np.uint64)
    assert got.shape == kx.shape
    assert not got.any(), kx[got != 0][:8]


def canonical_kmers(codes, k):
    """min(k0, k1) at each of the L - k + 1 positions (numpy)."""
    c = np.asarray(codes).astype(np.int64) & 3
    n = len(c) - k + 1
    k0 = np.zeros(n, np.int64)
    k1 = np.zeros(n, np.int64)
    for i in range(k):
        k0 |= c[i:i + n] << (2 * (k - 1 - i))
        k1 |= (3 - c[i:i + n]) << (2 * i)
    return np.minimum(k0, k1)


@pytest.mark.parametrize("k,w", [(1, 1), (7, 5), (11, 64), (15, 10),
                                 (16, 3), (16, 129)])
def test_plain_hash_is_the_canonical_kmer(k, w):
    codes = mixed_codes(k, w)
    h, pos, _, _ = sd.sketch_device_plain(torch.from_numpy(codes), k, w)
    canon = canonical_kmers(codes, k)
    np.testing.assert_array_equal(h.numpy().view(np.uint32),
                                  canon[pos.numpy()].astype(np.uint32))


@pytest.mark.parametrize("w", kbench.SKETCH_W_WIDE[:2])
@pytest.mark.parametrize("k", (15, 16))
def test_sketch_device_plain_matches_jax_past_w128(k, w):
    codes = mixed_codes(k, w, 2 * w + 57)
    assert_same(sd.sketch_device(torch.from_numpy(codes), k, w),
                jax_sketch(codes, k, w))
