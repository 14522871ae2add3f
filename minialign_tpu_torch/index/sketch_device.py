"""The (w,k)-minimizer sketch on a device: the port's counterpart of
minialign_tpu/index/sketch_jax.py, bit-compatible with index/sketch.py.

sketch_device computes, over every k-mer position of one sequence, the
window-minimum hash, its position and strand, and whether the position
emits an occurrence, as sketch_jax.py:39 does: the CUDA kernel S1
(csrc/sketch.cu, index/cuda_sketch.py) for a CUDA tensor, and
sketch_device_plain, the same array ops step by step in PyTorch, for a
CPU tensor. sketch_torch is sketch_jax's counterpart (:90): it compacts
the occurrences on the device and reads back only them.

As in the JAX module, the reference's packed 64-bit word (hash << 8 |
idx | strand << 7) is carried as a (hi = hash, lo = idx | strand << 7)
pair with a lexicographic window minimum, so the hash must fit 32 bits:
k <= 16. lo keeps idx and the strand bit apart for w <= 128 only; above
that both versions compute what the JAX function computes. PyTorch on
the CPU does not shift uint32 tensors, so the plain version carries its
32-bit words in int64 (every value stays below 2^32: no wrap-around to
mask). Hashes come back as uint32 (sketch_device) or as int32 tensors
holding the uint32 bits (the kernel and the plain version).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .sketch import _CRC_TABLE

BIG = 0xFFFFFFFF


def _check(k: int, w: int, L: int) -> None:
    if k > 16:
        raise ValueError("device sketch supports k <= 16")
    if k < 1 or w < 1:
        raise ValueError(f"device sketch needs k >= 1 and w >= 1 "
                         f"(k={k}, w={w})")
    if L - k + 1 >= 1 << 31:
        raise ValueError(f"device sketch takes fewer than 2^31 positions "
                         f"({L - k + 1})")


def _crc32c_u32pair(lo: torch.Tensor) -> torch.Tensor:
    """_mm_crc32_u64(kx, kx) with kx = lo < 2^32 (int64 words): the
    accumulator lo, folded with the 8 bytes of kx LSB-first, the high
    four zero (sketch_jax.py:25 with hi32 = 0)."""
    tbl = torch.from_numpy(_CRC_TABLE.astype(np.int64)).to(lo.device)
    r = lo
    for i in range(4):
        byte = (lo >> (8 * i)) & 0xFF
        r = (r >> 8) ^ tbl[(r ^ byte) & 0xFF]
    for _ in range(4):
        r = (r >> 8) ^ tbl[r & 0xFF]
    return r


def sketch_device_plain(codes: torch.Tensor, k: int, w: int):
    """sketch_device's plain version: sketch_jax.py:39's array ops in
    PyTorch on codes' device. Returns (hash as int32 bits, pos int32,
    strand uint8, emit bool) over the L - k + 1 positions (none when
    L < k, where the JAX function fails)."""
    _check(k, w, codes.numel())
    dev = codes.device
    n = codes.numel() - k + 1
    if n <= 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.uint8, device=dev),
                torch.empty(0, dtype=torch.bool, device=dev))
    # each int64 intermediate is freed once used (the card's 250 Mb run)
    c = codes.to(torch.int64) & 3
    mask = (1 << (2 * k)) - 1

    k0 = torch.zeros(n, dtype=torch.int64, device=dev)
    k1 = torch.zeros(n, dtype=torch.int64, device=dev)
    for i in range(k):
        ci = c[i:i + n]
        k0 |= ci << (2 * (k - 1 - i))
        k1 |= (3 ^ ci) << (2 * i)
    del c
    strand = k1 <= k0
    km = torch.where(strand, k1, k0)
    kx = torch.where(strand, k0, k1)
    del k0, k1
    h = (_crc32c_u32pair(kx) ^ km) & mask
    del km, kx

    pos_iota = torch.arange(n, dtype=torch.int64, device=dev)
    lo = (pos_iota % w) | (strand.to(torch.int64) << 7)
    del strand

    # trailing-w windowed lexicographic min over (h, lo), the newer taking
    # full ties: shifted copies folded oldest to newest
    mh = torch.full((n,), BIG, dtype=torch.int64, device=dev)
    ml = torch.full((n,), BIG, dtype=torch.int64, device=dev)
    ap = torch.zeros(n, dtype=torch.int64, device=dev)
    for d in range(w - 1, -1, -1):
        valid = pos_iota - d >= 0
        sh = torch.where(valid, torch.roll(h, d), BIG)
        sl = torch.where(valid, torch.roll(lo, d), BIG)
        upd = (sh < mh) | ((sh == mh) & (sl <= ml))
        mh = torch.where(upd, sh, mh)
        ml = torch.where(upd, sl, ml)
        ap = torch.where(upd, pos_iota - d, ap)

    same_prev = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=dev),
        (mh[1:] == mh[:-1]) & (ml[1:] == ml[:-1])])
    is_self = (mh == h) & (ml == lo)
    emit = ~same_prev | is_self
    pos = torch.where(is_self, pos_iota, ap)
    return (mh.to(torch.int32), pos.to(torch.int32),
            ((ml >> 7) & 1).to(torch.uint8), emit)


def sketch_device(codes: torch.Tensor, k: int, w: int):
    """codes: (L,) 2-bit codes on a device, k <= 16. Returns (hash uint32,
    pos int32, strand uint8, emit bool) over all k-mer positions;
    occurrences are the rows where emit is set (compacted by
    sketch_torch). The kernel for a CUDA tensor (it launches or raises),
    the plain version for a CPU tensor."""
    if codes.device.type == "cuda":
        from .cuda_sketch import sketch_cuda
        if codes.dtype not in (torch.int8, torch.uint8):
            codes = (codes & 3).to(torch.uint8)
        h, pos, strand, emit = sketch_cuda(codes.contiguous(), k, w)
    elif codes.device.type == "cpu":
        h, pos, strand, emit = sketch_device_plain(codes, k, w)
    else:
        raise ValueError(f"no device sketch for device {codes.device}")
    return h.view(torch.uint32), pos, strand, emit


def sketch_torch(codes, k: int, w: int, device="cuda"):
    """Compacted (hash uint64, pos int64, strand uint8) numpy arrays of
    codes (a numpy array), the contract of index/sketch.sketch: the sketch
    on `device` (the card unless the caller asks for the CPU), the
    occurrences gathered there and only they read back."""
    dev = resolve_device(device)
    codes = np.asarray(codes)
    if len(codes) - k + 1 <= 0:
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.uint8))
    _check(k, w, len(codes))           # before the copy below
    t = torch.from_numpy(np.ascontiguousarray(codes & 3, np.uint8)).to(dev)
    h, pos, strand, emit = sketch_device(t, k, w)
    idx = emit.nonzero().squeeze(1)
    # int32 bits: the card's torch may lack uint32 indexing
    return (h.view(torch.int32).index_select(0, idx).cpu().numpy()
            .view(np.uint32).astype(np.uint64),
            pos.index_select(0, idx).cpu().numpy().astype(np.int64),
            strand.index_select(0, idx).cpu().numpy())
