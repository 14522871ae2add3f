"""Batched adaptive-banded semi-global DP: constants, result tuples, the
plain PyTorch fill and the public `fill` dispatcher.

Port of minialign_tpu/dp/band.py (see its docstring for the band
geometry and the reference citations). `fill_plain` is the same batched
algorithm as `band.make_fill` in int32 torch ops: every problem steps
together, one anti-diagonal per step, 32 steps per block, until every
problem has terminated. It is the CPU path and the contract that the
CUDA kernel (csrc/fill.cu, dp/cuda_fill.py) is held against.

Lane q of the band at anti-diagonal step p holds cell
(i, j) = (ihead - q, (p + 2) - ihead + q); its characters are read
straight from the rows, a[i - 1] and b[j - 1], NCODE outside a row
(the rolled `achar`/`bchar` registers of the JAX fill hold the same
values).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..params import ScoreParams

BLK = 32           # steps per block, matches gaba's BLK (gaba.c:177)
NCODE = 4          # N sentinel code
TAIL_N = 96        # N-tail length per side (minialign.c:4516)

# mask indices (bits of a 6-bit cell code)
M_GFA, M_F, M_GFB, M_E, M_FO, M_EO = range(6)


class FillResult(NamedTuple):
    max_score: torch.Tensor   # (B,) int32, >= 0 (0 == empty)
    max_i: torch.Tensor       # (B,) int32: ref bases consumed at the max
    max_j: torch.Tensor       # (B,) int32: query bases consumed at the max
    n_steps: torch.Tensor     # (B,) int32: #anti-diagonal steps filled
    n_blocks: torch.Tensor    # () int32: #blocks filled (batch-wide)


class TraceBuffers(NamedTuple):
    masks: torch.Tensor       # (B, NB, BLK, 16) int32 packed cell codes:
                              # word r bits [8f, 8f+6) = lane r+16f's
                              # 6-bit code (the uint32 words of the JAX
                              # package, held as int32)
    dirs: torch.Tensor        # (B, NB) int32: bit s of block k = step
                              # k*32+s went down (uint32 bits as int32)
    iheads: torch.Tensor      # (B, NB) int32: ihead at each block start
    rprevs: torch.Tensor      # (B, NB) int32: rprev flag at block start


def score_floor(p: ScoreParams) -> int:
    """The naive oracle's score floor (gaba.c:4668)."""
    return int(np.iinfo(np.int16).min - p.min_match - 2 * p.gi)


def max_blocks_for(alen, blen) -> int:
    """Smallest block budget whose p-limit never binds before the
    per-problem one (alen + blen + 2*TAIL_N): results are then the same
    as under any larger budget."""
    m = int((np.asarray(alen, np.int64) + np.asarray(blen, np.int64)).max(
        initial=0))
    return -(-(m + 2 * TAIL_N + 2) // BLK) + 1


def fill_params(p: ScoreParams) -> list:
    """The scalar scoring constants every fill implementation reads, in
    the order csrc/fill.cu's FillParams declares them."""
    p.check()
    return ([int(x) for x in p.matrix55().reshape(-1)]
            + [p.gi, p.ge, p.gfa_eff, p.gfb_eff, p.gfa, p.gfb, p.model,
               score_floor(p), p.xdrop])


def _init_state(p: ScoreParams, W: int, B: int, dev) -> dict:
    """Band state at p = -1 (minialign_tpu/dp/band.py _init_band)."""
    c = W // 2
    floor = score_floor(p)
    g1b = max(int(p.gap_b(np.int64(1))), floor)     # cell (1, 0)
    g1a = max(int(p.gap_a(np.int64(1))), floor)     # cell (0, 1)
    S1 = np.full(W, floor, np.int32)
    S1[c - 1], S1[c] = g1b, g1a
    E1 = np.full(W, floor, np.int32)
    E1[c - 1] = g1b
    F1 = np.full(W, floor, np.int32)
    F1[c] = g1a
    S2 = np.full(W, floor, np.int32)
    S2[c] = 0                                        # cell (0, 0)

    def bcast(v):
        return torch.as_tensor(v, device=dev)[None, :].repeat(B, 1)

    z = torch.zeros(B, dtype=torch.int32, device=dev)
    return dict(S=bcast(S1), Sp=bcast(S2), E=bcast(E1), F=bcast(F1),
                ihead=torch.full((B,), c, dtype=torch.int32, device=dev),
                rprev=z.clone(), gmax=z.clone(), gi_=z.clone(),
                gj_=z.clone(), nsteps=z.clone(),
                term=torch.zeros(B, dtype=torch.bool, device=dev),
                cdrop=torch.full((B,), -128, dtype=torch.int32,
                                 device=dev))


def _chars(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[b, idx[b, q]] as int64, NCODE where idx is outside the row."""
    L = rows.shape[1]
    ok = (idx >= 0) & (idx < L)
    v = torch.gather(rows, 1, idx.clamp(0, max(L - 1, 0)).long())
    return torch.where(ok, v.long(), NCODE)


def fill_plain(p: ScoreParams, W: int, max_blocks: int, trace: bool,
               a: torch.Tensor, alen: torch.Tensor,
               b: torch.Tensor, blen: torch.Tensor):
    """Plain PyTorch fill on any device. a: (B, LA) int8 codes, NCODE
    past each problem's alen; alen: (B,) int32; likewise b. Returns
    FillResult, or (FillResult, TraceBuffers) when trace."""
    if W not in (16, 32, 64):
        raise ValueError(f"band width {W} not in (16, 32, 64)")
    prm = fill_params(p)
    dev = a.device
    B = a.shape[0]
    c = W // 2
    floor = score_floor(p)
    gi, ge = p.gi, p.ge
    gfa, gfb = p.gfa_eff, p.gfb_eff
    sub = torch.as_tensor(prm[:25], dtype=torch.int32, device=dev)
    a = a.to(torch.int8)
    b = b.to(torch.int8)
    alen = alen.to(device=dev, dtype=torch.int32)
    blen = blen.to(device=dev, dtype=torch.int32)
    st = _init_state(p, W, B, dev)
    plim = torch.clamp(alen + blen + 2 * TAIL_N, max=max_blocks * BLK - 2)
    q = torch.arange(W, dtype=torch.int32, device=dev)
    fill_col = torch.full((B, 1), floor, dtype=torch.int32, device=dev)
    shifts = torch.arange(BLK, dtype=torch.int64, device=dev)

    def up(x):      # out[q] = x[q + 1], floor rolled in at q = W-1
        return torch.cat([x[:, 1:], fill_col], 1)

    def dn(x):      # out[q] = x[q - 1], floor rolled in at q = 0
        return torch.cat([fill_col, x[:, :-1]], 1)

    if trace:
        masks = torch.zeros((B, max_blocks, BLK, 16), dtype=torch.int32,
                            device=dev)
        dirs = torch.zeros((B, max_blocks), dtype=torch.int32, device=dev)
        iheads = torch.zeros((B, max_blocks), dtype=torch.int32, device=dev)
        rprevs = torch.zeros((B, max_blocks), dtype=torch.int32, device=dev)

    pp = -1
    blk = 0
    while blk < max_blocks and not bool(st["term"].all()):
        if trace:
            iheads[:, blk] = st["ihead"]
            rprevs[:, blk] = st["rprev"]
            downs = []
        for s in range(BLK):
            S, Sp, E, F = st["S"], st["Sp"], st["E"], st["F"]
            ihead, rprev = st["ihead"], st["rprev"]
            # direction: down iff S[W-1] > S[0]; alternate while a band
            # edge is still outside the matrix (ramp-in)
            edge_ok = (ihead - (W - 1) >= 0) & ((pp + 2) - ihead >= 0)
            down = torch.where(edge_ok, S[:, W - 1] > S[:, 0],
                               ((pp + 1) & 1) == 1)
            d = down[:, None]
            SsrcE = torch.where(d, up(S), S)
            EsrcE = torch.where(d, up(E), E)
            SsrcF = torch.where(d, S, dn(S))
            FsrcF = torch.where(d, F, dn(F))
            E_new = torch.maximum(SsrcE - gi, EsrcE) - ge
            F_new = torch.maximum(SsrcF - gi, FsrcF) - ge
            sh = (down.to(torch.int32) - rprev)[:, None]
            Sdiag = torch.where(sh == 1, up(Sp),
                                torch.where(sh == -1, dn(Sp), Sp))

            ihead_new = ihead + (~down).to(torch.int32)
            p_new = pp + 1
            i_lane = ihead_new[:, None] - q[None, :]
            j_lane = (p_new + 2) - i_lane
            ac = _chars(a, i_lane - 1)
            bc = _chars(b, j_lane - 1)
            subsc = sub[bc * 5 + ac]
            S_new = torch.maximum(
                Sdiag + subsc,
                torch.maximum(torch.maximum(E_new, SsrcE - gfb),
                              torch.maximum(F_new, SsrcF - gfa)))
            S_new = torch.clamp(S_new, min=floor)

            if trace:
                code = ((S_new == SsrcF - gfa).to(torch.int32)
                        | ((S_new == F_new).to(torch.int32) << 1)
                        | ((S_new == SsrcE - gfb).to(torch.int32) << 2)
                        | ((S_new == E_new).to(torch.int32) << 3)
                        | ((S_new - gi >= F_new).to(torch.int32) << 4)
                        | ((S_new - gi >= E_new).to(torch.int32) << 5))
                word = code[:, 0:16]
                for f in range(1, W // 16):
                    word = word | (code[:, 16 * f:16 * (f + 1)] << (8 * f))
                masks[:, blk, s] = word
                downs.append(down)

            # true boundary values on the first row / column
            if p.model == 2:
                gap_a_j = torch.maximum(-gi * (j_lane > 0) - ge * j_lane,
                                        -p.gfa * j_lane)
                gap_b_i = torch.maximum(-gi * (i_lane > 0) - ge * i_lane,
                                        -p.gfb * i_lane)
            else:
                gap_a_j = -gi * (j_lane > 0) - ge * j_lane
                gap_b_i = -gi * (i_lane > 0) - ge * i_lane
            gap_a_j = torch.clamp(gap_a_j, min=floor).to(torch.int32)
            gap_b_i = torch.clamp(gap_b_i, min=floor).to(torch.int32)
            on_i0 = (i_lane == 0) & (j_lane >= 0)
            on_j0 = (j_lane == 0) & (i_lane >= 0)
            invalid = (i_lane < 0) | (j_lane < 0)
            S_new = torch.where(on_i0, gap_a_j, S_new)
            S_new = torch.where(on_j0, gap_b_i, S_new)
            S_new = torch.where(invalid, floor, S_new)
            E_new = torch.where(on_j0, gap_b_i, E_new)
            E_new = torch.where(on_i0 | invalid, floor, E_new)
            F_new = torch.where(on_i0, gap_a_j, F_new)
            F_new = torch.where(on_j0 | invalid, floor, F_new)

            # max: interior cells, strict greater, first lane on ties
            cand = torch.where(on_i0 | on_j0 | invalid, floor, S_new)
            step_max = cand.max(1).values
            step_arg = torch.where(cand == step_max[:, None], q,
                                   W).min(1).values
            upd = (step_max > st["gmax"]) & ~st["term"]
            gmax = torch.where(upd, step_max, st["gmax"])
            gi_ = torch.where(upd, ihead_new - step_arg, st["gi_"])
            gj_ = torch.where(upd, (p_new + 2) - (ihead_new - step_arg),
                              st["gj_"])
            # saturating int8 center-lane drop accumulator (gaba.c:1650)
            cdrop = torch.clamp(st["cdrop"] - (S_new[:, c] - S[:, c]),
                                -128, 127)
            st.update(S=S_new, Sp=S, E=E_new, F=F_new, ihead=ihead_new,
                      rprev=(~down).to(torch.int32), gmax=gmax, gi_=gi_,
                      gj_=gj_, cdrop=cdrop,
                      nsteps=st["nsteps"] + (~st["term"]).to(torch.int32))
            pp = p_new
        if trace:
            bits = (torch.stack(downs, 1).to(torch.int64) << shifts).sum(1)
            dirs[:, blk] = (bits - (bits >= 2 ** 31).to(torch.int64)
                            * 2 ** 32).to(torch.int32)
        # X-drop test at block end (gaba.c:1738) + p-limit
        st["term"] = st["term"] | (st["cdrop"] > p.xdrop - 128) \
            | (pp >= plim)
        blk += 1

    res = FillResult(max_score=st["gmax"], max_i=st["gi_"],
                     max_j=st["gj_"], n_steps=st["nsteps"],
                     n_blocks=torch.tensor(blk, dtype=torch.int32,
                                           device=dev))
    if trace:
        return res, TraceBuffers(masks=masks, dirs=dirs, iheads=iheads,
                                 rprevs=rprevs)
    return res


def fill(p: ScoreParams, W: int, max_blocks: int, trace: bool,
         a: torch.Tensor, alen: torch.Tensor,
         b: torch.Tensor, blen: torch.Tensor):
    """The fill on a's device: the CUDA kernel for CUDA tensors (it
    launches or raises), `fill_plain` for CPU tensors."""
    if a.device.type == "cuda":
        from .cuda_fill import fill_cuda
        return fill_cuda(p, W, max_blocks, trace, a, alen, b, blen)
    if a.device.type == "cpu":
        return fill_plain(p, W, max_blocks, trace, a, alen, b, blen)
    raise ValueError(f"no fill for device {a.device}")


def pad_codes(seqs, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Pack a list of code arrays into an N-padded (B, L) int8 batch."""
    lens = np.asarray([len(s) for s in seqs], np.int32)
    L = int(max(lens, default=0)) + TAIL_N + 128
    if pad_to is not None:
        L = max(L, pad_to)
    L = -(-L // 128) * 128
    out = np.full((len(seqs), L), NCODE, np.int8)
    for k, s in enumerate(seqs):
        out[k, :len(s)] = s
    return out, lens
