"""The port's sketch_torch (minialign_tpu_torch.index.sketch_device), the
counterpart of the JAX package's sketch_jax, on the CPU: the compacted
(hash, pos, strand) arrays equal sketch_jax's and the port's host
sketch's (index.sketch.sketch, the native sketch_seq) for w <= 64, and
sketch_jax's and the numpy path's above (both host libraries' sketch_seq
returns no occurrence for w > 64, a fault of the reference kept as it
is, confirmed here). Also its refusals (k = 17 in both packages, 2^31
positions, CUDA asked for where there is none), the empty result when L
< k, and csrc/sketch.cu's blocks (packed codes, k-mers by funnel shift,
the van Herk sliding minimum on 64-bit keys, the halo block before a
tile) modelled in numpy against the plain version at w-block and tile
edges."""

import numpy as np
import pytest
import torch

import minialign_tpu.native as jnative
from minialign_tpu.index.sketch import sketch as jax_host_sketch
from minialign_tpu.index.sketch_jax import sketch_device as jax_sketch_device
from minialign_tpu.index.sketch_jax import sketch_jax
from minialign_tpu_torch import kbench
from minialign_tpu_torch import native as tnative
from minialign_tpu_torch.index import cuda_sketch
from minialign_tpu_torch.index import sketch as tsketch
from minialign_tpu_torch.index.sketch_device import (sketch_device,
                                                     sketch_device_plain,
                                                     sketch_torch)
from test_torch_sketch import mixed_codes


def assert_arrays(got, want):
    for g, x in zip(got, want, strict=True):
        assert g.dtype == x.dtype, (g.dtype, x.dtype)
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("w", (2, 10, 64))
@pytest.mark.parametrize("k", kbench.SKETCH_K)
def test_sketch_torch_matches_sketch_jax_and_host(k, w):
    codes = mixed_codes(k, w)
    got = sketch_torch(codes, k, w, device="cpu")
    assert_arrays(got, sketch_jax(codes, k, w))
    assert tnative.available()
    assert_arrays(got, tsketch.sketch(codes & 3, k, w))


def _numpy_sketch(codes, k, w, monkeypatch):
    """index.sketch.sketch on its numpy path (the host library off)."""
    with monkeypatch.context() as m:
        m.setattr(tnative, "_lib", None)
        m.setattr(tnative, "_tried", True)
        return tsketch.sketch(codes & 3, k, w)


@pytest.mark.parametrize("k", (11, 15))
@pytest.mark.parametrize("w", (65, 128))
def test_sketch_torch_past_w64_matches_jax_and_numpy_path(k, w, monkeypatch):
    codes = mixed_codes(k, w)
    got = sketch_torch(codes, k, w, device="cpu")
    assert len(got[0])
    assert_arrays(got, sketch_jax(codes, k, w))
    assert_arrays(got, _numpy_sketch(codes, k, w, monkeypatch))


@pytest.mark.parametrize("pkg", ("jax", "port"))
def test_host_library_sketch_seq_emits_nothing_past_w64(pkg, monkeypatch):
    """The reference fault: the C sketch_seq of both host libraries
    (native/minialign_native.cpp:561, csrc/host/minialign_native.cpp:563)
    returns 0 occurrences for w > 64 and all of them up to 64; their
    Python wrappers return None there, so index.sketch.sketch takes the
    numpy path, which the device sketch matches."""
    nat = jnative if pkg == "jax" else tnative
    lib = nat._load()
    assert lib is not None
    nat._bind_sketch(lib)
    k = 15
    for w, emits in ((64, True), (65, False), (128, False)):
        codes = np.ascontiguousarray(mixed_codes(k, w) & 3, np.int8)
        L = len(codes)
        h, pos = np.empty(L, np.uint64), np.empty(L, np.int64)
        st = np.empty(L, np.uint8)
        n = lib.sketch_seq(codes, L, k, w, L, h, pos, st)
        want = sketch_torch(codes, k, w, device="cpu")
        assert len(want[0]) > 0
        if emits:
            assert_arrays((h[:n], pos[:n], st[:n]), want)
        else:
            assert n == 0, (pkg, w, n)
            assert nat.sketch_seq(codes, k, w) is None
    host = jax_host_sketch if pkg == "jax" else tsketch.sketch
    assert_arrays(host(codes, k, 128), want)


def test_k17_raises_in_both_packages():
    codes = np.random.default_rng(0).integers(0, 4, 100).astype(np.int8)
    t = torch.from_numpy(codes)
    for fn in (lambda: sketch_jax(codes, 17, 10),
               lambda: jax_sketch_device(codes, 17, 10),
               lambda: sketch_torch(codes, 17, 10, device="cpu"),
               lambda: sketch_device(t, 17, 10),
               lambda: sketch_device_plain(t, 17, 10)):
        with pytest.raises(ValueError, match="k <= 16"):
            fn()


@pytest.mark.parametrize("k", (1, 15, 16, 17))
def test_shorter_than_k_gives_empty_arrays(k):
    """As sketch_jax, which returns before it checks k."""
    for L in {0, max(k - 1, 0)}:
        codes = np.zeros(L, np.int8)
        got = sketch_torch(codes, k, 10, device="cpu")
        assert_arrays(got, sketch_jax(codes, k, 10))
        assert all(len(x) == 0 for x in got)
    if k <= 16:
        got = sketch_device(torch.zeros(k - 1, dtype=torch.int8), k, 10)
        assert [x.numel() for x in got] == [0] * 4


def test_2_to_31_positions_raise():
    """The JAX function's int32 positions would wrap there."""
    k = 15
    codes = np.broadcast_to(np.int8(0), ((1 << 31) + k - 1,))
    with pytest.raises(ValueError, match="2\\^31"):
        sketch_torch(codes, k, 10, device="cpu")


def test_sketch_torch_without_a_device_raises_where_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sketch_torch(np.zeros(100, np.int8), 15, 10)


U64 = np.uint64
TIE = (1 << 21) - 1        # csrc/sketch.cu's key slot field


def _brev32(x):
    """Bit reversal of uint64 words < 2^32 (csrc/sketch.cu's __brev)."""
    for sh, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                  (8, 0x00FF00FF), (16, 0x0000FFFF)):
        x = ((x >> U64(sh)) & U64(m)) | ((x & U64(m)) << U64(sh))
    return x


def tile_model(codes, k, w, blocks):
    """csrc/sketch.cu's blocks in numpy, tiles of `blocks` w-blocks
    (cuda_sketch.tile_blocks(w) in the kernel): each tile packs its codes
    (from the w-block before it, a halo, to k - 1 past its end; outside
    [0, L) as 0) 16 to a word, first code in the top bits, beside each
    word's reverse complement; takes each slot's k-mers by funnel shifts
    and its 64-bit key (h << 32 | lo << 21 | TIE - slot, BIG outside [0,
    n)); takes the windows' minima by van Herk / Gil-Werman on the
    w-blocks (a block's prefix minima, the suffix minima of the block
    before), each w-block's in segments as the kernel's lanes take them;
    and reads each position's outputs and emission from its
    window's key and the slot before's (at the tile's first position the
    halo block's last)."""
    codes = np.asarray(codes).astype(np.int64) & 3
    L = len(codes)
    n = L - k + 1
    T = blocks * w
    nb = blocks + 1
    mask = U64((1 << (2 * k)) - 1)
    m32 = U64(0xFFFFFFFF)
    big = U64(0xFFFFFFFFFFFFFFFF)
    out = [np.zeros(n, np.int64) for _ in range(4)]
    for tile0 in range(0, n, T):
        base = tile0 - w                       # slot 0's position
        cbase = base & ~15                     # the first word's code
        d0 = base - cbase
        nw = (nb * w - 1 + k - 1 + d0) // 16 + 2
        q = cbase + np.arange(16 * nw)
        c = np.where((q >= 0) & (q < L), codes[np.clip(q, 0, L - 1)], 0)
        W = (c.reshape(nw, 16).astype(U64)
             << (U64(30) - U64(2) * np.arange(16, dtype=U64))).sum(1,
                                                                  dtype=U64)
        y = _brev32(W)
        R = ~(((y & U64(0x55555555)) << U64(1))
              | ((y >> U64(1)) & U64(0x55555555))) & m32
        j = np.arange(nb * w)
        off = j + d0
        i, s = off >> 4, U64(2) * (off & 15).astype(U64)
        # __funnelshift_l(W[i + 1], W[i], s); __funnelshift_r(R[i],
        # R[i + 1], s)
        fwd = (((W[i] << U64(32)) | W[i + 1]) << s) >> U64(32) & m32
        k0 = fwd >> U64(32 - 2 * k)
        k1 = (((R[i + 1] << U64(32)) | R[i]) >> s) & mask
        h = np.minimum(k0, k1)
        lo = (j % w).astype(U64) | ((k1 <= k0).astype(U64) << U64(7))
        key = (h << U64(32)) | (lo << U64(21)) | (U64(TIE) - j.astype(U64))
        pq = base + j
        key[(pq < 0) | (pq >= n)] = big
        # a w-block's S segments of G slots (cuda_sketch.segments): each
        # segment's prefix and suffix minima, completed by the minima of
        # the segments before and after it
        S = cuda_sketch.segments(nb)
        G = cuda_sketch.segment_len(w, S)
        kb = np.full((nb, S * G), big)
        kb[:, :w] = key.reshape(nb, w)
        kb = kb.reshape(nb, S, G)
        z = kb.min(2)
        cp = np.minimum.accumulate(np.concatenate(
            [np.full((nb, 1), big), z[:, :-1]], 1), axis=1)
        cs = np.minimum.accumulate(np.concatenate(
            [z[:, 1:], np.full((nb, 1), big)], 1)[:, ::-1], axis=1)[:, ::-1]
        pre = np.minimum(np.minimum.accumulate(kb, axis=2), cp[:, :, None])
        suf = np.minimum(np.minimum.accumulate(kb[:, :, ::-1], axis=2)
                         [:, :, ::-1], cs[:, :, None])
        pre = pre.reshape(nb, S * G)[:, :w]
        suf = suf.reshape(nb, S * G)[:, :w]
        win = pre.copy()                       # a block's last: the block
        win[1:, :w - 1] = np.minimum(suf[:-1, 1:], pre[1:, :w - 1])
        win = win.reshape(-1)
        cnt = min(T, n - tile0)
        sl = w + np.arange(cnt)
        m, prev = win[sl], win[sl - 1]
        arg = U64(TIE) - (m & U64(TIE))
        same = (m >> U64(21)) == (prev >> U64(21))
        self_ = arg == sl.astype(U64)
        p = slice(tile0, tile0 + cnt)
        out[0][p] = (m >> U64(32)).astype(np.int64)
        out[1][p] = base + arg.astype(np.int64)
        out[2][p] = ((m >> U64(28)) & U64(1)).astype(np.int64)
        out[3][p] = ~same | self_
    return out


# 600 and 1024: the kernel's tiles of 3 and of 2 w-blocks
TILE_W = (1, 3, 10, 64, 128, 129, 300, 600, 1024)


@pytest.mark.parametrize("w", TILE_W)
@pytest.mark.parametrize("k", (1, 15, 16))
def test_kernel_tiling_model_matches_plain(k, w):
    """The model at tiles of 4 w-blocks (so that short codes reach the
    tile edges), or of the kernel's own count where that is fewer, on
    every code kind, at kbench.sketch_lengths (the w-block and tile
    edges); and at the kernel's own tile once."""
    rng = np.random.default_rng(100 * k + w)
    blocks = min(4, cuda_sketch.tile_blocks(w))
    cases = [(kind, L) for kind in kbench.SKETCH_KINDS
             for L in kbench.sketch_lengths(k, w, blocks * w) if L >= k]
    cases.append(("random", cuda_sketch.tile(w) + w + k + 5))
    for kind, L in cases:
        codes = kbench.sketch_codes(rng, kind, L, k)
        want = sketch_device_plain(torch.from_numpy(codes), k, w)
        nblk = blocks if L < cuda_sketch.tile(w) else \
            cuda_sketch.tile_blocks(w)
        for name, g, x in zip(("hash", "pos", "strand", "emit"),
                              tile_model(codes, k, w, nblk), want):
            np.testing.assert_array_equal(
                g, x.numpy().astype(np.int64) & 0xFFFFFFFF,
                err_msg=f"{name} k={k} w={w} L={L} {kind}")
