"""The up window of a fused down+up ("duo") batch, D1: its geometry
block and its plain PyTorch version. On the card it is the down fill's
epilogue (csrc/fill.cu:duo_window, through band.fill(..., duo=...)).

Replaces the device arithmetic of minialign_tpu/extend.py:675-737
(FillEngine._duo_fn): from the down fill's max and each problem's
geometry it computes the up windows (:703, :710-722) and writes them as
the up batch's packed descriptor block (cuda_gather.pack_desc layout,
2B rows), which gather_pair and the traced up fill read on the device;
and it copies the down score, i and j into the rows the harvest reads
with the walk's summary (:731-734), so a duo batch comes back in one
summary read-back. The geometry rides in the same upload as the down
batch's descriptor block (pack_geom).
"""

from __future__ import annotations

import numpy as np
import torch

from .band import TAIL_N
from .cuda_gather import WORDS

CAPU_ADD = 4 * 64 + 2 * TAIL_N + 64      # extend._slice_cap(tp1, 64) - 2 tp1
GEOM = ("rlen", "qlen", "cp0", "cp1")    # int32 fields after two int64 ones
GEOM_WORDS = 4 + len(GEOM)


def pack_geom(rvbase, qub, rlen, qlen, cp0, cp1) -> np.ndarray:
    """One int32 block of B problems' geometry: rvbase (the reference's
    reverse strand in the store) and qub (the read's other strand) as
    int64 over the first 4B words, then rlen, qlen, cp0, cp1 over B
    words each."""
    B = len(rlen)
    g = np.empty(GEOM_WORDS * B, np.int32)
    g[:4 * B].view(np.int64)[:] = np.concatenate(
        [np.asarray(rvbase, np.int64), np.asarray(qub, np.int64)])
    for k, x in enumerate((rlen, qlen, cp0, cp1)):
        g[(4 + k) * B:(5 + k) * B] = np.asarray(x, np.int32)
    return g


def geom_fields(geom: torch.Tensor) -> dict[str, torch.Tensor]:
    """Views of a packed geometry block: rvbase and qub (B,) int64, each
    of GEOM (B,) int32."""
    B = geom.numel() // GEOM_WORDS
    g64 = geom[:4 * B].view(torch.int64)
    out = {"rvbase": g64[:B], "qub": g64[B:]}
    for k, f in enumerate(GEOM):
        out[f] = geom[(4 + k) * B:(5 + k) * B]
    return out


def duo_window_plain(score: torch.Tensor, max_i: torch.Tensor,
                     max_j: torch.Tensor, geom: torch.Tensor,
                     out: torch.Tensor | None = None):
    """(desc, dsum): the up batch's packed descriptor block, (WORDS * 2B,)
    int32, and the down rows (3, B) int32 (written into `out` when
    given), on the inputs' device."""
    g = geom_fields(geom)
    B = len(g["rlen"])
    rlen, qlen = g["rlen"].long(), g["qlen"].long()
    tp0 = torch.minimum(torch.clamp(g["cp0"].long() + max_i.long(), min=1),
                        rlen)
    tp1 = torch.minimum(torch.clamp(g["cp1"].long() + max_j.long(), min=1),
                        qlen)
    ok = (score > 0).long()
    lna = torch.minimum(2 * tp1 + CAPU_ADD, tp0) * ok
    lnb = tp1 * ok
    dev = geom.device
    desc = torch.empty(WORDS * 2 * B, dtype=torch.int32, device=dev)
    desc[:4 * B].view(torch.int64).copy_(torch.cat([g["rvbase"], g["qub"]]))
    zero = torch.zeros(2 * B, dtype=torch.int64, device=dev)
    for k, v in enumerate((torch.cat([rlen - tp0, qlen - tp1]),
                           torch.cat([lna, lnb]), torch.cat([rlen, qlen]),
                           zero, torch.cat([lna, lnb]))):
        desc[(4 + 2 * k) * B:(6 + 2 * k) * B] = v.to(torch.int32)
    dsum = torch.stack([score, max_i, max_j]).to(torch.int32)
    if out is not None:
        out.copy_(dsum)
        dsum = out
    return desc, dsum
