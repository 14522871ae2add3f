"""Launch wrapper of the banded fill kernel (csrc/fill.cu).

Replaces minialign_tpu/dp/pallas_fill.py:make_fill_pallas (the Pallas
TPU kernel, whose semantics twin is minialign_tpu/dp/band.py:make_fill)
and is held against this package's band.fill_plain. One warp per
problem and per thread block; the kernel stops a problem at its own
termination, so trace blocks after that stay zero (the traceback never
reads past the max), and n_blocks is the largest per-problem block
count, which equals the batch-wide count of the batched reference.
An untraced launch given a duo geometry block also writes the duo's up
descriptor block and down rows in its epilogue (D1, held against
dp/duo.py:duo_window_plain).
"""

from __future__ import annotations

import ctypes

import torch

from ..params import ScoreParams

from .. import _build
from .band import BLK, FillResult, TraceBuffers, fill_params
from .cuda_gather import WORDS
from .duo import GEOM_WORDS


def _check_rows(x: torch.Tensor, n: torch.Tensor, name: str):
    if x.dtype != torch.int8 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (B, L) int8 tensor")
    if n.dtype != torch.int32 or n.shape != (x.shape[0],) or \
            n.device != x.device or not n.is_contiguous():
        raise ValueError(f"{name}len: need a contiguous (B,) int32 tensor "
                         "on the rows' device")


def _check_duo(geom: torch.Tensor, out: torch.Tensor, B: int, dev):
    if geom.dtype != torch.int32 or geom.shape != (GEOM_WORDS * B,) or \
            geom.device != dev or not geom.is_contiguous() or \
            geom.data_ptr() % 8:
        raise ValueError("fill: the duo geometry must be a packed "
                         "contiguous int32 block of the batch, 8-byte "
                         "aligned, on the rows' device")
    if out.dtype != torch.int32 or out.shape != (3, B) or \
            out.device != dev or (B and out.stride(1) != 1):
        raise ValueError("fill: the duo's down rows must be (3, B) int32 "
                         "with unit column stride on the rows' device")


def fill_cuda(p: ScoreParams, W: int, max_blocks: int, trace: bool,
              a: torch.Tensor, alen: torch.Tensor,
              b: torch.Tensor, blen: torch.Tensor, duo=None):
    """CUDA fill: same arguments and results as band.fill_plain. duo:
    (geom, out) on an untraced fill, the duo epilogue's geometry block
    (dp/duo.pack_geom) and the (3, B) int32 rows that take the down
    score, i and j; the result is then (FillResult, up descriptor
    block), as band.fill gives it."""
    if W not in (16, 32, 64):
        raise ValueError(f"band width {W} not in (16, 32, 64)")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("fill_cuda: a and b must be on one CUDA device")
    _check_rows(a, alen, "a")
    _check_rows(b, blen, "b")
    if b.shape[0] != a.shape[0]:
        raise ValueError("fill_cuda: a and b batch sizes differ")
    B = a.shape[0]
    dev = a.device
    prm = (ctypes.c_int32 * 34)(*fill_params(p))
    out = torch.zeros((5, B), dtype=torch.int32, device=dev)
    if trace:
        masks = torch.zeros((B, max_blocks, BLK, 16), dtype=torch.int32,
                            device=dev)
        dirs = torch.zeros((B, max_blocks), dtype=torch.int32, device=dev)
        iheads = torch.zeros((B, max_blocks), dtype=torch.int32, device=dev)
        rprevs = torch.zeros((B, max_blocks), dtype=torch.int32, device=dev)
    else:
        masks = dirs = iheads = rprevs = None
    geom = dsum = desc = None
    if duo is not None:
        if trace:
            raise ValueError("fill: the duo epilogue runs on an untraced "
                             "fill")
        geom, dsum = duo
        _check_duo(geom, dsum, B, dev)
        desc = torch.empty(WORDS * 2 * B, dtype=torch.int32, device=dev)
    if B:
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.fill_launch(
                a.data_ptr(), alen.data_ptr(), a.shape[1],
                b.data_ptr(), blen.data_ptr(), b.shape[1],
                B, W, max_blocks, int(trace), ctypes.addressof(prm),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                out[3].data_ptr(), out[4].data_ptr(),
                _build.ptr(masks), _build.ptr(dirs), _build.ptr(iheads),
                _build.ptr(rprevs), _build.ptr(geom), _build.ptr(desc),
                _build.ptr(dsum), dsum.stride(0) if duo is not None else 0,
                _build.stream_of(a))
        _build.count("fill")
        if duo is not None:
            _build.count("duo")
        if trace:
            _build.count_traced_fill(B)
        _build.check(lib, rc, "fill kernel")
    res = FillResult(max_score=out[0], max_i=out[1], max_j=out[2],
                     n_steps=out[3],
                     n_blocks=out[4].max() if B else
                     torch.zeros((), dtype=torch.int32, device=dev))
    if trace:
        return res, TraceBuffers(masks=masks, dirs=dirs, iheads=iheads,
                                 rprevs=rprevs)
    return res if duo is None else (res, desc)
