"""Copy of minialign_tpu/chain.py for the port, unchanged apart from
this header (its imports are relative, so they resolve in this package).

Seed collection and chaining.

Seed coordinate system (minialign.c:3340-3402): a (ref pos x, query pos
y) match is stored rotated as upos = 2x - y + OFS, vpos = 2y - x + OFS;
strand is folded in by bit-complementing the query position
(mm_expand, minialign.c:3420-3446). Chaining links seeds greedily
inside a 30-degree parallelogram window of edge twlen == wlen
(mm_chain_seeds, minialign.c:3547-3625): from the current front seed,
among all seeds with vpos in (v0, v0+win_v], upos <= win_u, same rid,
pick the one with the largest p-distance to the window tip; the window
tip shrinks as seeds are linked (the _update_wv coupling). Chains merge
when the front hits a seed already owned by an earlier chain. Chain
score plen = (1 - 1/scnt) * (p_end - p_start).

This is the serial greedy formulation; it runs on host (numpy/python).
A segmented-scan device formulation is the planned optimization once
SAM parity is locked (SURVEY.md section 7, hard part 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .index.build import MMIndex
from .index.sketch import sketch

OFS = 0x40000000
I32 = np.int32


def _unofs(stored: int) -> int:
    """int32 interpretation of _ofs-inverse: 0x40000000 - stored."""
    v = (0x40000000 - stored) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v
INT32_MAX = np.int32(0x7FFFFFFF)


def _u(x, y):
    return I32(2 * x - y + OFS)


def _v(x, y):
    return I32(2 * y - x + OFS)


def coords_to_xy(upos: int, vpos: int):
    """Back out (ref pos, query pos) from rotated coords: x = _as, y = _bs
    (minialign.c:3362-3363, C truncating division)."""
    ub, vb = int(upos) - OFS, int(vpos) - OFS
    x = int(np.trunc((2 * ub + vb) / 3))
    y = int(np.trunc((2 * vb + ub) / 3))
    return x, y


@dataclasses.dataclass
class SeedState:
    """Per-read seeding state carried across occurrence rounds
    (mm_tbuf_t seed/resc fields)."""
    upos: np.ndarray     # (n,) int32
    vpos: np.ndarray     # (n,) int32
    rid: np.ndarray      # (n,) int32  (sequence id, strand folded out)
    # rescue array: (qs, n, start) sorted by n after round 0
    resc: np.ndarray     # (m, 3) int64
    presc: int           # rescue pointer


def collect_seeds(mi: MMIndex, qcodes: np.ndarray) -> SeedState:
    """Round-0 seed collection (mm_collect_seed, minialign.c:3454-3493),
    fully vectorized: minimizer hits are classified (drop / rescue /
    expand) with boolean masks and the kept runs expanded with one
    repeat+gather (replacing the per-minimizer Python loop). The whole
    pass (sketch + lookup + expand) runs as ONE native call when the
    library and the bucket-major index layout are available; equality
    with this numpy path is enforced by tests/test_native.py."""
    from . import native
    r = native.collect_seeds(mi, qcodes)
    if r is not None:
        up, vp, rd, resc = r
        return SeedState(upos=up, vpos=vp, rid=rd, resc=resc, presc=0)
    h, qpos, fr = sketch(np.asarray(qcodes, np.int64) & 3, mi.k, mi.w)
    start, cnt = mi.lookup(h)

    fr64 = np.asarray(fr, np.int64)
    # qs = (qpos + k if rev else qpos) ^ -fr, int32 wrap (mm_collect_seed)
    qs = ((np.asarray(qpos, np.int64) + mi.k * fr64) ^ (-fr64)) \
        .astype(I32)

    keep = (cnt > 0) & (cnt <= mi.max_occ)
    resc_m = keep & (cnt > int(mi.occ[0]))
    exp_m = keep & ~resc_m

    if resc_m.any():
        resc = np.stack([qs[resc_m].astype(np.int64), cnt[resc_m],
                         start[resc_m]], axis=1)
    else:
        resc = np.zeros((0, 3), np.int64)
    up, vp, rd = _expand_many(mi, start[exp_m], cnt[exp_m], qs[exp_m])
    return SeedState(upos=up, vpos=vp, rid=rd, resc=resc, presc=0)


def _expand_many(mi: MMIndex, start: np.ndarray, cnt: np.ndarray,
                 qs: np.ndarray):
    """Vectorized mm_expand (minialign.c:3420-3446) over many hit runs
    at once (ava filtering omitted, as in the reference's read-to-ref
    path). start/cnt are int64 run descriptors into vals_pos/vals_rid;
    qs the per-run query positions (int32, strand pre-folded). Emission
    order — runs in input order, hits in index order within a run —
    matches the sequential loop exactly."""
    tot = int(cnt.sum())
    if tot == 0:
        z = np.empty(0, I32)
        return z, z.copy(), z.copy()
    rep = np.repeat(np.arange(len(cnt)), cnt)
    offs = np.arange(tot, dtype=np.int64) \
        - np.repeat(np.cumsum(cnt) - cnt, cnt)
    idx = start[rep] + offs
    pos = mi.vals_pos[idx].astype(np.int64)
    rf = mi.vals_rid[idx].astype(np.int64)
    q = qs[rep].astype(np.int64)

    rev = rf & 1
    x = pos + mi.k * rev                  # reverse hits shift +k
    y = np.where(rev != 0, ~q, q)         # int32 bit-not via 2's compl.
    # int64-exact math, single int32 wrap at the end ≡ the reference's
    # per-op int32 wrap (mod-2^32 homomorphism)
    up = (2 * x - y + OFS).astype(I32)
    vp = (2 * y - x + OFS).astype(I32)
    rd = (rf >> 1).astype(I32)
    return up, vp, rd


def seed_round(mi: MMIndex, st: SeedState, rnd: int) -> np.ndarray | None:
    """mm_seed (minialign.c:3500-3541): round-`rnd` seed set, sorted by
    (rid, upos) with ksort's exact radix permutation on ties (the seed
    array stays in its sorted order across rounds and re-sorts with the
    appended rescue seeds plus the tail sentinel, whose presence
    participates in the permutation). Returns the sorted arrays stacked
    as (n, 3) int64 [upos, rid, vpos] or None if no seeds this round."""
    from .ksort import ks_radix128
    if rnd > 0:
        if rnd == 1 and len(st.resc):
            # radix_sort_128x on mm_resc_t: key u64 = (n << 32) | qs
            # (minialign.c:3513, struct at :3176)
            rk = (st.resc[:, 1].astype(np.uint64) << np.uint64(32)) \
                | (st.resc[:, 0].astype(np.int64)
                   .astype(np.uint32).astype(np.uint64))
            st.resc = st.resc[ks_radix128(rk)]
        occ_r = int(mi.occ[rnd])
        p = st.presc
        # resc is sorted ascending by n after the rnd==1 sort, so the
        # expandable prefix is a binary search away
        pe = p + int(np.searchsorted(st.resc[p:, 1], occ_r, "right"))
        if pe > p:
            up, vp, rd = _expand_many(
                mi, st.resc[p:pe, 2], st.resc[p:pe, 1],
                st.resc[p:pe, 0].astype(I32))
            st.upos = np.concatenate([st.upos, up])
            st.vpos = np.concatenate([st.vpos, vp])
            st.rid = np.concatenate([st.rid, rd])
        st.presc = pe

    n = len(st.upos)
    if n == 0:
        return None
    # radix_sort_128x on mm_seed_t: key u64 = (rid << 32) | upos
    # (minialign.c:3535); the tail sentinel (rid INT32_MAX,
    # upos INT32_MIN, :3532) takes part in the permutation
    key = (st.rid.astype(np.int64).astype(np.uint32)
           .astype(np.uint64) << np.uint64(32)) \
        | st.upos.astype(np.int64).astype(np.uint32).astype(np.uint64)
    keys = np.concatenate(
        [key, np.asarray([0x7FFFFFFF80000000], np.uint64)])
    order = ks_radix128(keys)
    order = order[order < n]
    # the reference keeps the array sorted for the next round's append
    st.upos = st.upos[order]
    st.vpos = st.vpos[order]
    st.rid = st.rid[order]
    return np.stack([st.upos, st.rid, st.vpos], axis=1).astype(np.int64)


@dataclasses.dataclass
class Chain:
    plen: int            # real (un-offsetted) path-length score
    root_sid: int        # root seed index (extension anchor)
    leaf_sid: int        # first (leftmost) seed of the chain


def chain_seeds(seeds: np.ndarray, twlen: int,
                lens: np.ndarray | None = None,
                circular: np.ndarray | None = None) -> list[Chain]:
    """mm_chain_seeds (minialign.c:3547-3625). seeds: (n, 3) int64 of
    [upos, rid, vpos] sorted by (rid, upos). Returns chains sorted by
    plen descending (radix_sort_64x of offsetted plen ascending,
    minialign.c:3718). When lens/circular are given, chains whose tail
    reaches near the end of a circular reference are stitched to chains
    starting at its origin (mm_circularize, minialign.c:3632-3695)."""
    from . import native
    if native.available():
        zl = np.zeros(1, np.int64) if lens is None else lens
        zc = np.zeros(len(zl), np.uint8) if circular is None \
            else np.asarray(circular, np.uint8)
        rows = native.chain_seeds(seeds, twlen, zl, zc)
        if rows is not None:
            from .ksort import ks_radix64
            keys = np.asarray(
                [(0x40000000 - int(r[0])) & 0xFFFFFFFF for r in rows],
                np.uint32)
            order = ks_radix64(keys) if len(rows) else []
            return [Chain(plen=int(rows[i][0]), root_sid=int(rows[i][1]),
                          leaf_sid=int(rows[i][2])) for i in order]

    n = len(seeds)
    up, rid, vp = seeds[:, 0], seeds[:, 1], seeds[:, 2]
    lid_of = np.full(n, -1, np.int64)       # seed -> owning leaf
    leaves = []                             # (rsid, lsid, rid, cid)
    chains = []                             # (plen_real, lid)

    nlsid = 0
    while nlsid < n:
        lid = len(leaves)
        leaves.append([nlsid, nlsid, int(rid[nlsid]), -1])
        plen0 = int(up[nlsid] + vp[nlsid])
        scnt = 1
        nrsid = nlsid
        nlsid_next = None

        while True:
            rsid = nrsid
            # window from s[rsid]: (vlb=v0, vub, rid, uub)
            v0 = int(vp[rsid])
            vub = v0 + twlen
            uub = int(up[rsid]) + twlen
            r0 = int(rid[rsid])
            best = None                      # largest inside sid
            sid = rsid + 1
            while sid < n:
                if rid[sid] > r0 or up[sid] > uub:
                    if nlsid_next is None:
                        nlsid_next = sid
                    else:
                        nlsid_next = min(nlsid_next, sid)
                    break
                fv_v, fv_u = int(vp[sid]), int(up[sid])
                if not (fv_v > v0 and fv_v <= vub):
                    if nlsid_next is None:
                        nlsid_next = sid
                    else:
                        nlsid_next = min(nlsid_next, sid)
                    sid += 1
                    continue
                # inside: link candidate; shrink window (_update_wv).
                # the reference's pdiff key (minialign.c:3580) is
                # identically zero after _update_wv, so the winning
                # candidate is simply the largest sid inside the
                # progressively-shrunk window.
                new_uub = uub - (vub - fv_v)
                new_vub = vub - (uub - fv_u)
                uub, vub = new_uub, new_vub
                best = sid
                sid += 1

            if sid >= n and nlsid_next is None:
                nlsid_next = n
            if best is None:
                nrsid = rsid
                break
            nsid = best
            if lid_of[nsid] != -1:
                nrsid = nsid
                break
            lid_of[nsid] = lid
            scnt += 1
            nrsid = nsid
            if nlsid_next is not None and nlsid_next <= nrsid:
                nlsid_next = None

        nlsid = nlsid_next if nlsid_next is not None else n

        if nrsid == leaves[lid][1]:          # nothing linked
            continue

        cid = -1
        if lid_of[nrsid] != -1 and lid_of[nrsid] < lid:
            # merged into an existing chain: adopt its root + cid
            other = int(lid_of[nrsid])
            nrsid = leaves[other][0]
            owner = lid_of[nrsid]
            if owner != -1:
                cid = leaves[int(owner)][3]
        if cid == -1:
            cid = len(chains)
            chains.append([0, lid])

        leaves[lid][3] = cid
        leaves[lid][0] = nrsid

        plen = int((1.0 - 1.0 / scnt) * (int(up[nrsid] + vp[nrsid]) - plen0))
        if plen > chains[cid][0]:
            chains[cid] = [plen, lid]

    if circular is not None and len(chains) and np.any(circular):
        _circularize(seeds, leaves, chains, twlen, lens, circular)

    # radix_sort_64x on mm_root_t: key u32 = the stored offsetted plen
    # (minialign.c:3718) — ascending offsetted = descending real, with
    # ksort's tie permutation. Consumed (circularized-away) chains keep
    # their 0x80000000-marked keys, sort last, and terminate the
    # evaluation loop via the plen threshold, as in the reference.
    from .ksort import ks_radix64
    keys = np.asarray([(0x40000000 - c[0]) & 0xFFFFFFFF for c in chains],
                      np.uint32)
    order = ks_radix64(keys) if len(chains) else []
    return [Chain(plen=chains[i][0], root_sid=leaves[chains[i][1]][0],
                  leaf_sid=leaves[chains[i][1]][1]) for i in order]


def _circularize(seeds, leaves, chains, twlen, lens, circular):
    """mm_circularize (minialign.c:3632-3695): for each chain whose
    root (tail) seed lies within twlen of the end of a circular
    reference, find the best chain whose leaf (head) seed — viewed
    shifted one full reference length forward — falls inside the
    standard parallelogram window of that root; merge the pair by
    propagating the leaf chain's root seed and score into the root
    chain and marking the leaf chain consumed (plen := -1 here, the
    0x80000000 mark in the reference)."""
    up, rid_a, vp = seeds[:, 0], seeds[:, 1], seeds[:, 2]
    blid, tlid = 0, len(leaves)

    for rcid in range(len(chains)):
        rlid = chains[rcid][1]
        rsid = leaves[rlid][0]
        rid = leaves[rlid][2]
        rlen = int(lens[rid])
        # root seed must be within twlen of the circular ref's end
        x0 = coords_to_xy(up[rsid], vp[rsid])[0]
        if not circular[rid] or rlen - x0 > twlen:
            continue
        uofs, vofs = 2 * rlen, -rlen            # _ud/_vd(rlen, 0)
        v0, u0 = int(vp[rsid]), int(up[rsid])
        vlb, vub = v0 - vofs, v0 - vofs + twlen
        uub = u0 + twlen - uofs

        # forward the shared leaf pointer (minialign.c:3652-3661)
        while blid < tlid and rid_a[leaves[blid][1]] < rid:
            blid += 1
        while blid < tlid and vp[leaves[blid][1]] > vub:
            blid += 1

        # match root to leaf: largest live leaf-chain plen, tie -> lowest lid
        best = None                             # (-plen, lid)
        for lid in range(blid, tlid):
            lsid = leaves[lid][1]
            lv, lu, lr = int(vp[lsid]), int(up[lsid]), int(rid_a[lsid])
            if not (lv > vlb and lv <= vub and lr <= rid and lu <= uub):
                continue
            cid = leaves[lid][3]
            if cid == -1 or chains[cid][0] < 0:
                continue
            key = (-chains[cid][0], lid)
            if best is None or key < best:
                best = key
        if best is None:
            continue
        pdiff, llid = -best[0], best[1]
        lcid = leaves[llid][3]

        # fixup leaf-side chain, then root-side chain + leaf bins.
        # The consumed mark is the stored (offsetted) plen with the top
        # bit set (minialign.c:3688); carry the exact int32 value the
        # reference would hold so the final radix sort permutation and
        # the evaluation-loop break see identical keys. A self-merge
        # additionally runs the root-side subtraction on the marked
        # value (reference statement order, :3688-3692).
        chains[lcid][1] = rlid
        stored_l = (0x40000000 - chains[lcid][0]) & 0xFFFFFFFF
        marked = stored_l | 0x80000000
        if lcid != rcid:
            chains[lcid][0] = _unofs(marked)
            chains[rcid][0] += pdiff
        else:
            stored2 = (marked + stored_l - 0x40000000) & 0xFFFFFFFF
            chains[lcid][0] = _unofs(stored2)
        leaves[rlid][0] = leaves[llid][0]       # propagate root seed
