"""Device traceback (csrc/dtrace.cu) and its plain PyTorch version.

Replaces minialign_tpu/dp/dtrace.py:make_device_traceback. Both forms
walk the fill's cell codes backward from (ai, bj) with gaba's
trace_core state machine, exactly as minialign_tpu/dp/traceback.py
traceback_one does, and return

  rle      (B, T) uint8, T = NB*BLK + 2: row b holds n_ent[b] backward
           entries op | len << 2 (op 1 'D', 2 'R', 3 diagonal), one
           maximal run of an op per entry, split every 63 ops;
  summary  (14, B) int32 with rows SUMMARY_ROWS (t_fin = the batch's
           largest n_ent: the rle columns a harvest needs).

The JAX walker chunked runs by its XLA probe depth (CHAIN), so its
n_ent/t_fin differ; decoded paths and every other row are the same.
`dtrace_plain` advances every live problem by one move per iteration,
batched over problems; the kernel runs one warp per problem.
"""

from __future__ import annotations

import ctypes

import torch

from ..params import ScoreParams

from .. import _build
from .band import BLK, M_E, M_EO, M_F, M_FO, M_GFA, M_GFB

OP_PAD, OP_D, OP_R, OP_X = 0, 1, 2, 3
LEN_CAP = 63
SUMMARY_ROWS = ("n_ops", "n_ent", "bad", "dcnt", "agcnt", "bgcnt",
                "n_open", "n_ext", "gf_pen", "e_pen",
                "score", "ai", "bj", "t_fin")


def _popc32(x: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits of an int64 tensor."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def dtrace_plain(p: ScoreParams, W: int, masks: torch.Tensor,
                 dirs: torch.Tensor, iheads: torch.Tensor,
                 score: torch.Tensor, ai: torch.Tensor, bj: torch.Tensor):
    """Plain PyTorch walk on the tensors' device; see the module doc."""
    dev = masks.device
    B, NB = dirs.shape
    T = NB * BLK + 2
    NS = NB * BLK
    codes = masks.reshape(B, NS * 16).to(torch.int64) & 0xFFFFFFFF
    dw = dirs.to(torch.int64) & 0xFFFFFFFF
    sc = score.to(torch.int64)
    i = ai.to(torch.int64).clone()
    j = bj.to(torch.int64).clone()
    z = torch.zeros(B, dtype=torch.int64, device=dev)

    empty = (sc <= 0) | ((i == 0) & (j == 0))
    pp = i + j - 2
    # ihead at band pp: first ihead + right moves of steps 0 .. pp
    if NB:
        full = torch.cumsum(BLK - _popc32(dw), 1)
        blk0 = (pp.clamp(min=0) // BLK).clamp(max=NB - 1)
        infull = torch.where(blk0 > 0, full.gather(
            1, (blk0 - 1).clamp(min=0)[:, None])[:, 0], 0)
        rem = pp.clamp(min=0) % BLK + 1
        lastw = dw.gather(1, blk0[:, None])[:, 0]
        inlast = rem - _popc32(lastw & ((1 << rem) - 1))
        ihead = iheads[:, 0].to(torch.int64) + torch.where(
            pp >= 0, infull + inlast, 0)
    else:
        ihead = z.clone()
    q = ihead - i
    bad = ~empty & ((q < 0) | (q >= W) | (pp >= NS))
    done = empty | bad

    cnt = {k: z.clone() for k in ("dcnt", "agcnt", "bgcnt", "n_open",
                                  "n_ext", "gf_pen", "e_pen")}
    phase = z.clone()             # 0 normal, 1 f-run, 2 e-run, 3/4 drain
    head = torch.ones(B, dtype=torch.bool, device=dev)
    cur_op, cur_len, n_ent, n_ops = z.clone(), z.clone(), z.clone(), \
        z.clone()
    rle = torch.zeros((B, T), dtype=torch.uint8, device=dev)
    m2 = p.model == 2

    def cell(pp_, q_):
        qc = q_.clamp(0, W - 1)
        idx = pp_.clamp(0, max(NS - 1, 0)) * 16 + (qc & 15)
        w = codes.gather(1, idx[:, None])[:, 0]
        return (w >> ((qc >> 4) << 3)) & 0x3F

    def dir_at(pp_):
        k = pp_.clamp(0, max(NS - 1, 0))
        w = dw.gather(1, (k >> 5)[:, None])[:, 0]
        return torch.where(pp_ >= 0, (w >> (k & 31)) & 1, 0)

    def flush(mask, length):
        nonlocal n_ent, n_ops
        idx = mask.nonzero()[:, 0]
        rle[idx, n_ent[idx]] = (cur_op[idx] | (length[idx] << 2)).to(
            torch.uint8)
        n_ops = n_ops + torch.where(mask, length, 0)
        n_ent = n_ent + mask.to(torch.int64)

    it, cap = 0, 4 * T + 8
    while it < cap and bool((~done).any()):
        it += 1
        live = ~done
        at_i0 = live & (i == 0)
        at_j0 = live & (j == 0) & ~at_i0
        inb = (q >= 0) & (q < W)
        oob = live & ~at_i0 & ~at_j0 & ~inb
        act = live & ~at_i0 & ~at_j0 & inb
        c = cell(pp, q)
        hb = ((c >> M_E) | (c >> M_GFB)) & 1
        vb = ((c >> M_F) | (c >> M_GFA)) & 1
        eb = (((c >> M_E) & ~(c >> M_GFB)) | (c >> M_EO)) & 1
        fb = (((c >> M_F) & ~(c >> M_GFA)) | (c >> M_FO)) & 1
        # a run arrived at this cell: stop or take one more op
        stop_e = act & (phase == 2) & (hb == 0) & (eb == 1)
        stop_f = act & (phase == 1) & (vb == 0) & (fb == 1)
        cont_e = act & (phase == 2) & ~stop_e
        cont_f = act & (phase == 1) & ~stop_f
        # normal dispatch: head tests h; tail tests v, else falls to h
        norm = act & (phase == 0)
        h_disp = norm & (head | (vb == 0))
        v_disp = norm & ~head & (vb == 1)
        b_hgf = h_disp & (hb == 1) & (eb == 0)
        b_e = h_disp & (hb == 1) & (eb == 1)
        b_dg = h_disp & (hb == 0)
        b_vgf = v_disp & (fb == 0)
        b_f = v_disp & (fb == 1)
        step_e = b_e | cont_e
        step_f = b_f | cont_f
        mv_r = b_hgf | step_e
        mv_d = b_vgf | step_f

        # ---- counters; a boundary run is priced whole on entry
        ent_i0 = at_i0 & (phase != 3)
        ent_j0 = at_j0 & (phase != 4)
        win_a = (p.gfa * j < p.gi + j * p.ge) if m2 else \
            torch.zeros_like(done)
        win_b = (p.gfb * i < p.gi + i * p.ge) if m2 else \
            torch.zeros_like(done)
        one = torch.ones_like(z)
        cnt["dcnt"] += b_dg.long()
        cnt["agcnt"] += torch.where(ent_j0, i, 0) + mv_r.long()
        cnt["bgcnt"] += torch.where(ent_i0, j, 0) + mv_d.long()
        cnt["n_open"] += (b_e | b_f | (ent_i0 & ~win_a)
                          | (ent_j0 & ~win_b)).long()
        cnt["n_ext"] += (step_e | step_f).long() \
            + torch.where(ent_i0 & ~win_a, j, 0) \
            + torch.where(ent_j0 & ~win_b, i, 0)
        cnt["gf_pen"] += torch.where(b_hgf, p.gfb_eff * one, 0) \
            + torch.where(b_vgf, p.gfa_eff * one, 0) \
            + torch.where(ent_i0 & win_a, p.gfa * j, 0) \
            + torch.where(ent_j0 & win_b, p.gfb * i, 0)
        cnt["e_pen"] += torch.where(b_hgf, p.gfb_eff * one, 0) \
            + torch.where(b_e, p.gi * one, 0) \
            + torch.where(step_e, p.ge * one, 0) \
            + torch.where(ent_j0, torch.where(win_b, p.gfb * i,
                                              p.gi + i * p.ge), 0)

        # ---- emission, merged into the open entry
        n = torch.where(at_i0, j.clamp(max=LEN_CAP),
                        torch.where(at_j0, i.clamp(max=LEN_CAP),
                                    (mv_r | mv_d | b_dg).long()))
        op = torch.where(at_i0 | mv_d, OP_D,
                         torch.where(at_j0 | mv_r, OP_R, OP_X))
        em = n > 0
        same = em & (cur_len > 0) & (cur_op == op)
        take = torch.where(same, torch.minimum(n, LEN_CAP - cur_len), 0)
        rest = n - take
        fl = em & ((~same & (cur_len > 0)) | (same & (rest > 0)))
        flush(fl, cur_len + take)
        cur_len = torch.where(same & (rest == 0), cur_len + take,
                              torch.where(em, rest, cur_len))
        cur_op = torch.where(em, op, cur_op)

        # ---- moves
        d0 = dir_at(pp)
        d1 = dir_at(pp - 1)
        q_n = q + torch.where(mv_r, d0, 0) - torch.where(mv_d, 1 - d0, 0) \
            + torch.where(b_dg, d0 - (1 - d1), 0)
        i_n = i - (mv_r | b_dg).long() - torch.where(at_j0, n, 0)
        j_n = j - (mv_d | b_dg).long() - torch.where(at_i0, n, 0)
        pp_n = pp - (mv_r | mv_d).long() - 2 * b_dg.long()

        phase = torch.where(at_i0, 3, torch.where(at_j0, 4, phase))
        phase = torch.where(stop_e | stop_f | b_hgf | b_vgf | b_dg, 0, phase)
        phase = torch.where(step_e, torch.where(i_n > 0, 2, 0), phase)
        phase = torch.where(step_f, torch.where(j_n > 0, 1, 0), phase)
        head = torch.where(mv_r, True, torch.where(b_dg, False, head))

        moved = mv_r | mv_d | b_dg
        post_bad = moved & ((q_n < -1) | (q_n > W))
        bad = bad | oob | post_bad
        done = done | oob | post_bad | (live & (i_n == 0) & (j_n == 0))
        i, j, pp, q = i_n, j_n, pp_n, q_n

    flush(cur_len > 0, cur_len)
    summ = torch.stack([n_ops, n_ent, bad.long(), cnt["dcnt"],
                        cnt["agcnt"], cnt["bgcnt"], cnt["n_open"],
                        cnt["n_ext"], cnt["gf_pen"], cnt["e_pen"], sc,
                        ai.to(torch.int64), bj.to(torch.int64),
                        n_ent.max().expand(B) if B else n_ent])
    return rle, summ.to(torch.int32)


def _trace_params(p: ScoreParams, W: int):
    return (ctypes.c_int32 * 8)(W, p.model, p.gi, p.ge, p.gfa, p.gfb,
                                p.gfa_eff, p.gfb_eff)


def dtrace(p: ScoreParams, W: int, masks: torch.Tensor,
           dirs: torch.Tensor, iheads: torch.Tensor, score: torch.Tensor,
           ai: torch.Tensor, bj: torch.Tensor):
    """The walk on the masks' device: the CUDA kernel for CUDA tensors
    (launches or raises), dtrace_plain for CPU tensors."""
    if masks.device.type == "cpu":
        return dtrace_plain(p, W, masks, dirs, iheads, score, ai, bj)
    if masks.device.type != "cuda":
        raise ValueError(f"no traceback for device {masks.device}")
    B, NB = dirs.shape
    if masks.shape != (B, NB, BLK, 16) or iheads.shape != (B, NB):
        raise ValueError("dtrace: trace buffer shapes disagree")
    ins = [t.contiguous() for t in (masks, dirs, iheads, score, ai, bj)]
    for t in ins:
        if t.dtype != torch.int32 or t.device != masks.device:
            raise ValueError("dtrace: inputs must be int32 on one device")
    T = NB * BLK + 2
    rle = torch.zeros((B, T), dtype=torch.uint8, device=masks.device)
    summ = torch.zeros((len(SUMMARY_ROWS), B), dtype=torch.int32,
                       device=masks.device)
    if B:
        lib = _build.library()
        prm = _trace_params(p, W)
        with torch.cuda.device(masks.device):
            rc = lib.dtrace_launch(
                *(t.data_ptr() for t in ins), B, NB,
                ctypes.addressof(prm), rle.data_ptr(), summ.data_ptr(), T,
                _build.stream_of(masks))
        _build.count("dtrace")
        _build.check(lib, rc, "traceback kernel")
        summ[SUMMARY_ROWS.index("t_fin")] = summ[1].max()
    return rle, summ
