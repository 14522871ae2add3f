"""The device minimizer sketch S1 (csrc/sketch.cu): its wrapper.

Replaces minialign_tpu/index/sketch_jax.py:39 (sketch_device; XLA). The
plain PyTorch version, the contract the kernel is held to, is
index/sketch_device.py:sketch_device_plain.
"""

from __future__ import annotations

import torch

from .. import _build

TILE = 1024             # positions a block (csrc/sketch.cu)
MAX_W = 1024            # the widest window the kernel takes
MAX_K = 16              # the hash fits 32 bits


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
            rc = lib.sketch_launch(codes.data_ptr(), L, k, w, h.data_ptr(),
                                   pos.data_ptr(), strand.data_ptr(),
                                   emit.data_ptr(), _build.stream_of(codes))
        _build.count("sketch")
        _build.check(lib, rc, "sketch kernel")
    return h, pos, strand, emit
