"""The device minimizer sketch S1 (csrc/sketch.cu): its wrapper.

Replaces minialign_tpu/index/sketch_jax.py:39 (sketch_device; XLA). The
plain PyTorch version, the contract the kernel is held to, is
index/sketch_device.py:sketch_device_plain.
"""

from __future__ import annotations

import torch

from .. import _build

BLOCK = 256             # threads a block (csrc/sketch.cu)
SLOTS = 2570            # (h, lo) slots a block's tile aims at: ~44 KB of
                        # shared memory, five blocks an SM
MAX_W = 1024            # the widest window the kernel takes
MAX_K = 16              # the hash fits 32 bits


def tile_blocks(w: int) -> int:
    """w-blocks of positions a block's tile, at least 2: with the halo
    block a multiple of BLOCK where SLOTS holds that many, so that every
    thread takes as many w-blocks in the kernel's passes. The kernel takes
    it, segments() and segment_len() as arguments and checks them."""
    nb = SLOTS // w
    if nb >= BLOCK:
        return nb // BLOCK * BLOCK - 1
    return nb - 1 if nb > 3 else 2


def segments(nb: int) -> int:
    """Lanes a w-block's passes are split over in a tile of nb w-blocks
    (the halo's included): the largest power of 2 up to 32 that leaves a
    lane for each segment; 1 where the w-blocks fill the threads."""
    s = 1
    while s < 32 and 2 * s * nb <= BLOCK:
        s *= 2
    return s


def segment_len(w: int, S: int) -> int:
    """Slots a lane's segment of a w-block takes (w for S = 1). A
    half-warp's 16 lanes are 16 / S groups of neighbouring w-blocks (one
    group for S >= 16), and a group's lanes read 8-byte words G (nb | 1)
    apart in the kernel's [slot][w-block] arrays: G an odd multiple of m
    = max(16 / S, 1) makes that an odd multiple of m, so the 16 words
    fall in 16 banks."""
    if S == 1:
        return w
    m = max(16 // S, 1)
    G = m
    while G * S < w:
        G += 2 * m
    return G


def tile(w: int) -> int:
    """Positions a block's tile: tile_blocks(w) windows of w."""
    return tile_blocks(w) * w


def sketch_cuda(codes: torch.Tensor, k: int, w: int):
    """(hash, pos, strand, emit) over the L - k + 1 k-mer positions of
    codes, a contiguous 1-D int8 or uint8 CUDA tensor (taken & 3): hash
    as int32 tensors holding the uint32 bits, pos int32, strand uint8,
    emit bool. One launch when there is a position."""
    if codes.device.type != "cuda" or codes.dim() != 1 or \
            codes.dtype not in (torch.int8, torch.uint8) or \
            not codes.is_contiguous():
        raise ValueError("sketch_cuda: codes must be a contiguous 1-D int8 "
                         "or uint8 CUDA tensor")
    if not (1 <= k <= MAX_K and 1 <= w <= MAX_W):
        raise ValueError(f"sketch_cuda: needs 1 <= k <= {MAX_K} and "
                         f"1 <= w <= {MAX_W} (k={k}, w={w})")
    L = codes.numel()
    n = max(L - k + 1, 0)
    if n >= 1 << 31:
        raise ValueError(f"sketch_cuda: {n} positions (at most 2^31 - 1)")
    dev = codes.device
    h = torch.empty(n, dtype=torch.int32, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    strand = torch.empty(n, dtype=torch.uint8, device=dev)
    emit = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        lib = _build.library()
        with torch.cuda.device(dev):
            blocks = tile_blocks(w)
            segs = segments(blocks + 1)
            rc = lib.sketch_launch(codes.data_ptr(), L, k, w, blocks, segs,
                                   segment_len(w, segs), h.data_ptr(),
                                   pos.data_ptr(),
                                   strand.data_ptr(), emit.data_ptr(),
                                   _build.stream_of(codes))
        _build.count("sketch")
        _build.check(lib, rc, "sketch kernel")
    return h, pos, strand, emit
