"""The port's sketch_torch (minialign_tpu_torch.index.sketch_device), the
counterpart of the JAX package's sketch_jax, on the CPU: the compacted
(hash, pos, strand) arrays equal sketch_jax's and the port's host
sketch's (index.sketch.sketch, the native sketch_seq) for w <= 64, and
sketch_jax's and the numpy path's above (both host libraries' sketch_seq
returns no occurrence for w > 64, a fault of the reference kept as it
is, confirmed here). Also its refusals (k = 17 in both packages, 2^31
positions, CUDA asked for where there is none), the empty result when L
< k, and csrc/sketch.cu's tiling (halo, the window of the position before
a tile) modelled in numpy against the plain version."""

import numpy as np
import pytest
import torch

import minialign_tpu.native as jnative
from minialign_tpu.index.sketch import sketch as jax_host_sketch
from minialign_tpu.index.sketch_jax import sketch_device as jax_sketch_device
from minialign_tpu.index.sketch_jax import sketch_jax
from minialign_tpu_torch import kbench
from minialign_tpu_torch import native as tnative
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


def tile_model(codes, k, w, tile):
    """csrc/sketch.cu's blocks in numpy: each tile of positions hashes
    its slots from tile0 - w on (positions before 0 as (BIG, BIG)), scans
    each of its positions' windows and the position before the tile, and
    compares neighbours within the tile."""
    # each position's own hash and strand: the sketch at w = 1
    h, _, strand, _ = (x.numpy().astype(np.int64) for x in
                       sketch_device_plain(torch.from_numpy(codes), k, 1))
    n = len(codes) - k + 1
    big = 0xFFFFFFFF
    h &= big                          # the uint32 the kernel compares
    lo = (np.arange(n) % w) | (strand << 7)
    out = [np.zeros(n, np.int64) for _ in range(4)]
    for tile0 in range(0, n, tile):
        base = tile0 - w
        H = np.full(tile + w, big)
        LO = np.full(tile + w, big)
        for j in range(tile + w):
            q = base + j
            if 0 <= q < n:
                H[j], LO[j] = h[q], lo[q]

        def scan(j):
            mh = ml = big
            d_at = 0
            for d in range(w - 1, -1, -1):
                sh, sl = H[j - d], LO[j - d]
                if sh < mh or (sh == mh and sl <= ml):
                    mh, ml, d_at = sh, sl, d
            return mh, ml, d_at
        MH = {0: scan(w - 1)[:2]} if tile0 > 0 else {}
        for i in range(min(tile, n - tile0)):
            mh, ml, d_at = scan(w + i)
            MH[i + 1] = (mh, ml)
            p = tile0 + i
            same_prev = p > 0 and MH[i] == (mh, ml)
            is_self = mh == H[w + i] and ml == LO[w + i]
            for a, v in zip(out, (mh, p if is_self else p - d_at,
                                  (ml >> 7) & 1,
                                  (not same_prev) or is_self)):
                a[p] = v
    return out


@pytest.mark.parametrize("k,w,tile", [(15, 10, 32), (4, 3, 8), (16, 128, 64),
                                      (1, 1, 8), (10, 64, 16)])
def test_kernel_tiling_model_matches_plain(k, w, tile):
    rng = np.random.default_rng(k + w + tile)
    for kind in kbench.SKETCH_KINDS:
        for L in (k, k + tile - 1, k + tile, 2 * tile + k, 3 * tile + k + 5):
            codes = kbench.sketch_codes(rng, kind, L, k)
            want = sketch_device_plain(torch.from_numpy(codes), k, w)
            for g, x in zip(tile_model(codes, k, w, tile), want):
                np.testing.assert_array_equal(g, x.numpy().astype(np.int64)
                                              & 0xFFFFFFFF)

