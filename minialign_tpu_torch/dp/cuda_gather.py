"""Store-window gather (csrc/gather.cu) and its plain PyTorch version.

Replaces minialign_tpu/dp/pallas_gather.py:make_gather and implements
the contract of its XLA twin FillEngine._gather_fn
(minialign_tpu/extend.py:499-523), circular wrap included: row b is
store[base_b + start_b ...] up to cap_b columns (and the segment end
unless wrapping), NCODE after. The 1 MB store row grid, the 8-row DMA
alignment and the 131072-column cap of the TPU kernel are not carried:
they served Mosaic's aligned DMAs and jit recompiles.

One launch gathers both sides of a fill batch (gather_pair), each side
from its own store, with every row's fields in one packed descriptor
block (pack_desc) that the fill's lengths share; the engine uploads it
once a batch (upload).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .band import NCODE

# the packed descriptor block: per row, int32 words in struct-of-arrays
# order, base (int64, two words) first
FIELDS = ("start", "cap", "seglen", "wrap", "elen")
WORDS = 2 + len(FIELDS)
VEC = 16              # bytes a kernel thread writes; rows are multiples


def _meta(store, base, start, cap, seglen, wrap):
    dev = store.device
    return (torch.as_tensor(base, dtype=torch.int64, device=dev),
            *(torch.as_tensor(x, dtype=torch.int32, device=dev)
              for x in (start, cap, seglen, wrap)))


def pad_store(flat: np.ndarray) -> np.ndarray:
    """flat (int8 codes) with NCODE appended up to a multiple of 16 bytes
    and 16 more, so that the kernel's two aligned 16-byte loads of any
    in-segment vector stay inside the store. The padding is never
    selected: no gathered byte changes."""
    n = len(flat)
    out = np.full(-(-n // VEC) * VEC + VEC, NCODE, np.int8)
    out[:n] = flat
    return out


def pack_desc(sides) -> np.ndarray:
    """One int32 block for the rows of all `sides` in order (dicts of
    per-row base, start, cap, seglen, wrap, elen arrays): base as int64
    over the first 2R words, then each of FIELDS over R words."""
    R = sum(len(s["base"]) for s in sides)
    desc = np.empty(WORDS * R, np.int32)
    desc[:2 * R].view(np.int64)[:] = np.concatenate(
        [np.asarray(s["base"], np.int64) for s in sides])
    for k, f in enumerate(FIELDS):
        desc[(2 + k) * R:(3 + k) * R] = np.concatenate(
            [np.asarray(s[f], np.int32) for s in sides])
    return desc


def desc_fields(desc: torch.Tensor) -> dict[str, torch.Tensor]:
    """Views of a packed block: base (R,) int64 and each of FIELDS (R,)
    int32, on the block's device."""
    R = desc.numel() // WORDS
    out = {"base": desc[:2 * R].view(torch.int64)}
    for k, f in enumerate(FIELDS):
        out[f] = desc[(2 + k) * R:(3 + k) * R]
    return out


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """x on the device. On a CUDA device: one non-blocking copy from
    pinned memory, so the host does not wait for the stream (PyTorch's
    caching host allocator keeps the pinned block until the copy has
    run). On the CPU: x itself, as a tensor."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


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


def gather_pair_plain(store_a: torch.Tensor, store_b: torch.Tensor,
                      desc: torch.Tensor, Ba: int, La: int,
                      Lb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """gather_pair's plain version: gather_plain of the block's first Ba
    rows from store_a at La columns and of the rest from store_b at Lb."""
    f = desc_fields(desc)
    keys = ("base", "start", "cap", "seglen", "wrap")
    return (gather_plain(store_a, *(f[k][:Ba] for k in keys), La),
            gather_plain(store_b, *(f[k][Ba:] for k in keys), Lb))


def _check_store(store: torch.Tensor, what: str):
    if store.dtype != torch.int8 or store.dim() != 1 or \
            not store.is_contiguous() or store.data_ptr() % VEC:
        raise ValueError(f"gather: {what} must be a contiguous 1-D int8 "
                         f"tensor, 16-byte aligned")


def gather_pair(store_a: torch.Tensor, store_b: torch.Tensor,
                desc: torch.Tensor, Ba: int, La: int,
                Lb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Both sides of a fill batch, on the stores' device: (Ba, La) rows
    from store_a for the block's first Ba rows and (R - Ba, Lb) rows
    from store_b for the rest; desc is the packed block (pack_desc) on
    that device. One kernel launch for a CUDA store (it launches or
    raises), gather_pair_plain for a CPU store. La and Lb must be
    multiples of 16."""
    if store_a.device.type == "cpu":
        return gather_pair_plain(store_a, store_b, desc, Ba, La, Lb)
    if store_a.device.type != "cuda":
        raise ValueError(f"no gather for device {store_a.device}")
    dev = store_a.device
    _check_store(store_a, "store_a")
    _check_store(store_b, "store_b")
    if store_b.device != dev or desc.device != dev or \
            desc.dtype != torch.int32 or desc.dim() != 1 or \
            not desc.is_contiguous() or desc.numel() % WORDS:
        raise ValueError("gather: desc must be a packed contiguous int32 "
                         "block on the stores' device")
    R = desc.numel() // WORDS
    if not 0 <= Ba <= R:
        raise ValueError(f"gather: Ba={Ba} outside the block's {R} rows")
    if La % VEC or Lb % VEC or La < 0 or Lb < 0:
        raise ValueError(f"gather: La={La}, Lb={Lb} not multiples of 16")
    out_a = torch.empty((Ba, La), dtype=torch.int8, device=dev)
    out_b = torch.empty((R - Ba, Lb), dtype=torch.int8, device=dev)
    if out_a.numel() or out_b.numel():
        lib = _build.library()
        with torch.cuda.device(dev):
            rc = lib.gather_pair_launch(
                store_a.data_ptr(), store_a.numel(), store_b.data_ptr(),
                store_b.numel(), desc.data_ptr(), Ba, R - Ba, La, Lb,
                out_a.data_ptr(),
                out_b.data_ptr(), _build.stream_of(store_a))
        _build.count("gather")
        _build.check(lib, rc, "gather kernel")
    return out_a, out_b
