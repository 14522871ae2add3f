"""Store-window gather (csrc/gather.cu) and its plain PyTorch version.

Replaces minialign_tpu/dp/pallas_gather.py:make_gather and implements
the contract of its XLA twin FillEngine._gather_fn
(minialign_tpu/extend.py:499-523), circular wrap included: row b is
store[base_b + start_b ...] up to cap_b columns (and the segment end
unless wrapping), NCODE after. The 1 MB store row grid, the 8-row DMA
alignment and the 131072-column cap of the TPU kernel are not carried:
they served Mosaic's aligned DMAs and jit recompiles.
"""

from __future__ import annotations

import torch

from .. import _build
from .band import NCODE


def _meta(store, base, start, cap, seglen, wrap):
    dev = store.device
    return (torch.as_tensor(base, dtype=torch.int64, device=dev),
            *(torch.as_tensor(x, dtype=torch.int32, device=dev)
              for x in (start, cap, seglen, wrap)))


def gather_plain(store: torch.Tensor, base, start, cap, seglen, wrap,
                 L: int) -> torch.Tensor:
    """(B, L) int8 rows from the flat int8 store, on the store's device."""
    base, start, cap, seglen, wrap = _meta(store, base, start, cap,
                                           seglen, wrap)
    col = torch.arange(L, dtype=torch.int64, device=store.device)[None, :]
    idx = start[:, None].long() + col
    w = wrap[:, None].long()
    idxw = torch.where(w > 0, torch.remainder(idx, w.clamp(min=1)), idx)
    sl = seglen[:, None].long()
    safe = torch.minimum(idxw.clamp(min=0), sl - 1).clamp(min=0)
    vals = store[(base[:, None] + safe).clamp(0, store.numel() - 1)]
    ok = (col < cap[:, None]) & ((w > 0) | (idx < sl)) & (sl > 0)
    return torch.where(ok, vals, NCODE).to(torch.int8)


def gather(store: torch.Tensor, base, start, cap, seglen, wrap,
           L: int) -> torch.Tensor:
    """The gather on the store's device: the CUDA kernel for a CUDA
    store (launches or raises), gather_plain for a CPU store. L must be
    a multiple of 4."""
    if store.device.type == "cpu":
        return gather_plain(store, base, start, cap, seglen, wrap, L)
    if store.device.type != "cuda":
        raise ValueError(f"no gather for device {store.device}")
    if store.dtype != torch.int8 or store.dim() != 1 or \
            not store.is_contiguous():
        raise ValueError("gather: store must be a contiguous 1-D int8 tensor")
    if L % 4:
        raise ValueError(f"gather: L={L} is not a multiple of 4")
    base, start, cap, seglen, wrap = _meta(store, base, start, cap,
                                           seglen, wrap)
    B = base.shape[0]
    out = torch.empty((B, L), dtype=torch.int8, device=store.device)
    if B and L:
        lib = _build.library()
        with torch.cuda.device(store.device):
            rc = lib.gather_launch(
                store.data_ptr(), base.data_ptr(), start.data_ptr(),
                cap.data_ptr(), seglen.data_ptr(), wrap.data_ptr(), B, L,
                out.data_ptr(), _build.stream_of(store))
        _build.count("gather")
        _build.check(lib, rc, "gather kernel")
    return out
