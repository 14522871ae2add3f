// Adaptive-banded semi-global SWG fill, one warp per problem.
//
// Replaces minialign_tpu/dp/pallas_fill.py:make_fill_pallas (Pallas, TPU;
// semantics twin minialign_tpu/dp/band.py:make_fill) and is held against
// minialign_tpu_torch/dp/band.py:fill_plain, bit for bit.
//
// Band geometry: lane q of the band at anti-diagonal step p holds cell
// (i, j) = (ihead - q, p + 2 - ihead + q); its characters are a[i - 1]
// and b[j - 1], NCODE outside the row. Thread t of the problem's warp
// holds lanes NL t .. NL t + NL - 1 (NL = 2 at W = 64, else 1; at W = 16
// threads 16-31 idle at the floor), so a one-lane roll of the band
// (roll_q in band.py) is one shuffle plus register moves.
//
// What bounds it: one problem's serial chain of steps. The engine groups
// requests by length, so a traced launch holds a few problems and the
// kernel's time is one problem's step latency times its ~30-40 k steps;
// bytes (2 characters a lane a step, 64 code bytes a step) and
// operations (~30 integer ops a cell) are far below the card's rates.
// The first version's step took ~850-1,000 cycles: global character
// loads, a 10-shuffle max butterfly and rolls issued after the direction
// was known, all on the chain. Here a step takes ~245-275 cycles traced
// and ~170-195 untraced on an H100, issue-bound: one warp issues the step's
// ~190 instructions in order, with little else to hide their latency.
// The design:
// - Characters come from shared memory. At each 32-step block start the
//   warp stores the W + 64 bases of a and of b that the band can touch in
//   this block (loaded into registers during the previous block, so the
//   global loads are off the chain), and the substitution scores of both
//   candidate cells of the next step are looked up as soon as the
//   direction of this step is known.
// - The step max leaves the step: each thread keeps its best cell (value,
//   first step, row) with strict >, and one warp reduction at the end
//   orders them by value descending, step ascending, lane ascending, which
//   is "the first step whose max beats gmax (init 0), lowest lane".
// - The X-drop accumulator stays on the thread that holds the center lane
//   W/2 and is broadcast once a block, for the test at the block end.
// - Both candidate rolls of S, E and F are issued with the two edge
//   shuffles that decide the direction, then selected; the rolls of the
//   previous S (for the diagonal source) are the ones the previous step
//   already made. A step has 6 shuffles, all independent.
// - A block whose start has every lane at i >= 1 and j >= 1 (the band has
//   left the first row and column; i and j never decrease) runs a bulk
//   step with no boundary or ramp-in code.
// - The max terms use the DPX instructions (__viaddmax_s32, __vimax3_s32).
// - The step loop is unrolled by 4, so that a step's trace code, best
//   cell and drop overlap the next step's shuffles.
// - Trace codes go to shared memory a byte a lane; at the block end the
//   warp packs them into the JAX layout with coalesced 128-byte stores.
// - One warp per thread block, so the problems of a small launch spread
//   over the SMs.
//
// Trace layout (the JAX package's, unchanged): masks[b][blk][s][r] holds
// the 6-bit codes of lanes r + 16 f at bits [8 f, 8 f + 6).

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 32;
constexpr int NCODE = 4;
constexpr int TAIL_N = 96;
constexpr unsigned FULL = 0xffffffffu;

struct FillParams {
  int sub[25];   // sub[b * 5 + a]: query base b against ref base a
  int gi, ge, gfa_eff, gfb_eff, gfa, gfb, model, floor_, xdrop;
};

template <int W>
struct Geo {
  static constexpr int NL = W == 64 ? 2 : 1;       // lanes a thread
  static constexpr int NT = W / NL;                // threads that hold lanes
  static constexpr int WIN = W + 64;               // bases a side a block
  static constexpr int NWIN = (WIN + 31) / 32;     // of them a thread loads
  static constexpr int C = W / 2;                  // X-drop center lane
  static constexpr int TC = C / NL, KC = C % NL;   // its thread and slot
};

template <int W>
struct Smem {
  int sub[25];
  int8_t sa[Geo<W>::WIN];    // a[abase + x]
  int8_t sb5[Geo<W>::WIN];   // 5 * b[bbase + x]
  uint8_t code[BLK * W];     // the block's cell codes: [s][lane]
};

template <int W>
struct Band {
  static constexpr int NL = Geo<W>::NL;
  int S[NL], Sp[NL], Spu[NL], Spd[NL], E[NL], F[NL];
  int scd[NL], scr[NL];      // this step's scores: down / right cell
  int ihead, rprev, p;
  int bv, bp, bi;            // the thread's best cell: value, step, i
  int cdrop;                 // valid on thread TC
};

// out[q] = x[q + 1], fill at q = W - 1
template <int W>
__device__ __forceinline__ void roll_up(const int* x, int* out, int fill,
                                        int t) {
  constexpr int NL = Geo<W>::NL;
  const int v = __shfl_down_sync(FULL, x[0], 1);
#pragma unroll
  for (int k = 0; k + 1 < NL; ++k) out[k] = x[k + 1];
  out[NL - 1] = t >= Geo<W>::NT - 1 ? fill : v;
}

// out[q] = x[q - 1], fill at q = 0
template <int W>
__device__ __forceinline__ void roll_dn(const int* x, int* out, int fill,
                                        int t) {
  constexpr int NL = Geo<W>::NL;
  const int v = __shfl_up_sync(FULL, x[NL - 1], 1);
#pragma unroll
  for (int k = NL - 1; k > 0; --k) out[k] = x[k - 1];
  out[0] = t == 0 ? fill : v;
}

// The substitution scores of both cells a lane can take at the step
// from (ihead, p): down keeps ihead, right takes ihead + 1.
template <int W>
__device__ __forceinline__ void scores(const Smem<W>& sm, int ihead, int p,
                                       int abase, int bbase, const int* q,
                                       int* scd, int* scr) {
#pragma unroll
  for (int k = 0; k < Geo<W>::NL; ++k) {
    const int ad = ihead - q[k] - 1 - abase;
    const int bd = p + 2 - ihead + q[k] - bbase;
    scd[k] = sm.sub[sm.sb5[bd] + sm.sa[ad]];
    scr[k] = sm.sub[sm.sb5[bd - 1] + sm.sa[ad + 1]];
  }
}

// row[base + x] for this thread's x = t + 32 m, NCODE outside the row
template <int W>
__device__ __forceinline__ void load_window(const int8_t* __restrict__ row,
                                            int L, int base, int t,
                                            int* r) {
#pragma unroll
  for (int m = 0; m < Geo<W>::NWIN; ++m) {
    const int x = t + 32 * m, idx = base + x;
    r[m] = (x < Geo<W>::WIN && idx >= 0 && idx < L) ? __ldg(row + idx)
                                                      : NCODE;
  }
}

template <int W, bool TRACE, bool BULK>
__device__ __forceinline__ void step(Band<W>& st, Smem<W>& sm,
                                     const FillParams& P, int t,
                                     const int* q, int s, int abase,
                                     int bbase, uint32_t& dirbits) {
  using G = Geo<W>;
  constexpr int NL = G::NL;
  const int fl = P.floor_, gi = P.gi, ge = P.ge;
  const int gfa = P.gfa_eff, gfb = P.gfb_eff;

  // every roll the step may need, issued with the direction's shuffles
  int Su[NL], Sdn[NL], Eu[NL], Fd[NL];
  roll_up<W>(st.S, Su, fl, t);
  roll_dn<W>(st.S, Sdn, fl, t);
  roll_up<W>(st.E, Eu, fl, t);
  roll_dn<W>(st.F, Fd, fl, t);
  const int s0 = __shfl_sync(FULL, st.S[0], 0);
  const int sW = __shfl_sync(FULL, st.S[NL - 1], G::NT - 1);
  // direction: down iff S[W-1] > S[0], alternating during ramp-in
  bool down = sW > s0;
  if constexpr (!BULK) {
    const bool edge_ok =
        (st.ihead - (W - 1) >= 0) && (st.p + 2 - st.ihead >= 0);
    if (!edge_ok) down = ((st.p + 1) & 1) == 1;
  }
  const int ihn = st.ihead + (down ? 0 : 1);
  const int pn = st.p + 1;
  int nscd[NL], nscr[NL];
  if (s + 1 < BLK) scores<W>(sm, ihn, pn, abase, bbase, q, nscd, nscr);

  int Sn[NL], En[NL], Fn[NL];
  uint32_t cw = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int SE = down ? Su[k] : st.S[k];
    const int EE = down ? Eu[k] : st.E[k];
    const int SF = down ? st.S[k] : Sdn[k];
    const int FF = down ? st.F[k] : Fd[k];
    const int Sg = down ? (st.rprev ? st.Sp[k] : st.Spu[k])
                        : (st.rprev ? st.Spd[k] : st.Sp[k]);
    const int sc = down ? st.scd[k] : st.scr[k];
    int e = __viaddmax_s32(SE, -gi, EE) - ge;
    int f = __viaddmax_s32(SF, -gi, FF) - ge;
    int sn = __vimax3_s32(Sg + sc, e, SE - gfb);
    sn = max(__vimax3_s32(sn, f, SF - gfa), fl);
    if constexpr (TRACE) {
      const uint32_t code = (uint32_t)(sn == SF - gfa) |
                            ((uint32_t)(sn == f) << 1) |
                            ((uint32_t)(sn == SE - gfb) << 2) |
                            ((uint32_t)(sn == e) << 3) |
                            ((uint32_t)(sn - gi >= f) << 4) |
                            ((uint32_t)(sn - gi >= e) << 5);
      cw |= code << (8 * k);
    }
    int cand = sn;
    const int i = ihn - q[k];
    if constexpr (!BULK) {
      // true boundary values on the first row / column
      const int j = pn + 2 - i;
      int gaj = -(j > 0 ? gi : 0) - ge * j;
      int gbi = -(i > 0 ? gi : 0) - ge * i;
      if (P.model == 2) {
        gaj = max(gaj, -P.gfa * j);
        gbi = max(gbi, -P.gfb * i);
      }
      gaj = max(gaj, fl);
      gbi = max(gbi, fl);
      const bool on_i0 = i == 0 && j >= 0;
      const bool on_j0 = j == 0 && i >= 0;
      const bool inv = i < 0 || j < 0;
      if (on_i0) sn = gaj;
      if (on_j0) sn = gbi;
      if (inv) sn = fl;
      if (on_j0) e = gbi;
      if (on_i0 || inv) e = fl;
      if (on_i0) f = gaj;
      if (on_j0 || inv) f = fl;
      if (on_i0 || on_j0 || inv) cand = fl;
    }
    if (W == 16 && t >= 16) sn = e = f = cand = fl;   // idle half-warp
    if (cand > st.bv) {
      st.bv = cand;
      st.bp = pn;
      st.bi = i;
    }
    Sn[k] = sn;
    En[k] = e;
    Fn[k] = f;
  }
  // saturating int8 center-lane drop accumulator (gaba.c:1650)
  st.cdrop = min(max(st.cdrop - (Sn[G::KC] - st.S[G::KC]), -128), 127);
  if constexpr (TRACE) {
    if (t < G::NT) {
      if constexpr (NL == 2)
        *reinterpret_cast<uint16_t*>(&sm.code[s * W + 2 * t]) =
            (uint16_t)cw;
      else
        sm.code[s * W + t] = (uint8_t)cw;
    }
    dirbits |= (down ? 1u : 0u) << s;
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    st.Sp[k] = st.S[k];
    st.Spu[k] = Su[k];
    st.Spd[k] = Sdn[k];
    st.S[k] = Sn[k];
    st.E[k] = En[k];
    st.F[k] = Fn[k];
    if (s + 1 < BLK) {
      st.scd[k] = nscd[k];
      st.scr[k] = nscr[k];
    }
  }
  st.ihead = ihn;
  st.rprev = down ? 0 : 1;
  st.p = pn;
}

template <int W, bool TRACE>
__global__ void __launch_bounds__(32)
fill_kernel(FillParams P, const int8_t* __restrict__ a,
            const int32_t* __restrict__ alen, int LA,
            const int8_t* __restrict__ b, const int32_t* __restrict__ blen,
            int LB, int max_blocks, int32_t* __restrict__ o_score,
            int32_t* __restrict__ o_i, int32_t* __restrict__ o_j,
            int32_t* __restrict__ o_steps, int32_t* __restrict__ o_blocks,
            uint32_t* __restrict__ masks, uint32_t* __restrict__ dirs,
            int32_t* __restrict__ iheads, int32_t* __restrict__ rprevs) {
  using G = Geo<W>;
  constexpr int NL = G::NL;
  constexpr int c = G::C;
  __shared__ Smem<W> sm;
  const int t = threadIdx.x;
  const int prob = blockIdx.x;
  if (t < 25) sm.sub[t] = P.sub[t];
  const int8_t* arow = a + (size_t)prob * LA;
  const int8_t* brow = b + (size_t)prob * LB;
  const int fl = P.floor_;

  int q[NL];   // the thread's lanes (idle threads alias lane W - 1)
#pragma unroll
  for (int k = 0; k < NL; ++k) q[k] = min(NL * t + k, W - 1);

  // band state at p = -1 (band.py _init_band)
  int g1b = -P.gi - P.ge, g1a = -P.gi - P.ge;
  if (P.model == 2) {
    g1b = max(g1b, -P.gfb);
    g1a = max(g1a, -P.gfa);
  }
  g1b = max(g1b, fl);
  g1a = max(g1a, fl);
  Band<W> st;
  const bool idle = W == 16 && t >= 16;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    st.S[k] = idle ? fl : (q[k] == c - 1 ? g1b : (q[k] == c ? g1a : fl));
    st.E[k] = !idle && q[k] == c - 1 ? g1b : fl;
    st.F[k] = !idle && q[k] == c ? g1a : fl;
    st.Sp[k] = !idle && q[k] == c ? 0 : fl;
  }
  roll_up<W>(st.Sp, st.Spu, fl, t);
  roll_dn<W>(st.Sp, st.Spd, fl, t);
  st.ihead = c;
  st.rprev = 0;
  st.p = -1;
  st.bv = 0;
  st.bp = INT_MAX;
  st.bi = 0;
  st.cdrop = -128;
  int nsteps = 0, nblk = 0;
  const int plim = min(alen[prob] + blen[prob] + 2 * TAIL_N,
                       max_blocks * BLK - 2);

  // the first block's window is based at its own start; every later
  // block's at the previous block's start, which covers it
  int abase = st.ihead - W, bbase = st.p - st.ihead + 1;
  int ra[G::NWIN], rb[G::NWIN];
  load_window<W>(arow, LA, abase, t, ra);
  load_window<W>(brow, LB, bbase, t, rb);

  for (int blk = 0; blk < max_blocks; ++blk) {
    const size_t bi = (size_t)prob * max_blocks + blk;
    __syncwarp();
#pragma unroll
    for (int m = 0; m < G::NWIN; ++m) {
      const int x = t + 32 * m;
      if (x < G::WIN) {
        sm.sa[x] = (int8_t)ra[m];
        sm.sb5[x] = (int8_t)(5 * rb[m]);
      }
    }
    __syncwarp();
    const int na = st.ihead - W, nb = st.p - st.ihead + 1;
    load_window<W>(arow, LA, na, t, ra);   // the next block's window
    load_window<W>(brow, LB, nb, t, rb);
    if (TRACE && t == 0) {
      iheads[bi] = st.ihead;
      rprevs[bi] = st.rprev;
    }
    scores<W>(sm, st.ihead, st.p, abase, bbase, q, st.scd, st.scr);
    uint32_t dirbits = 0;
    if (st.ihead - (W - 1) >= 1 && st.p + 2 - st.ihead >= 1) {
#pragma unroll 4
      for (int s = 0; s < BLK; ++s)
        step<W, TRACE, true>(st, sm, P, t, q, s, abase, bbase, dirbits);
    } else {
#pragma unroll 4
      for (int s = 0; s < BLK; ++s)
        step<W, TRACE, false>(st, sm, P, t, q, s, abase, bbase, dirbits);
    }
    nsteps += BLK;
    ++nblk;
    if constexpr (TRACE) {
      __syncwarp();
      uint32_t* mrow = masks + bi * BLK * 16;
#pragma unroll 4
      for (int w = t; w < BLK * 16; w += 32) {
        const uint8_t* cs = sm.code + (w >> 4) * W + (w & 15);
        uint32_t v = cs[0];
        if (W >= 32) v |= (uint32_t)cs[16] << 8;
        if (W == 64) v |= (uint32_t)cs[32] << 16 | (uint32_t)cs[48] << 24;
        mrow[w] = v;
      }
      if (t == 0) dirs[bi] = dirbits;
    }
    abase = na;
    bbase = nb;
    // X-drop test at block end (gaba.c:1738) + p-limit
    const int cdrop = __shfl_sync(FULL, st.cdrop, G::TC);
    if (cdrop > P.xdrop - 128 || st.p >= plim) break;
  }

  // the best cell: value descending, step ascending, lane ascending
  // (a lower lane at one step is a larger i)
  int bv = st.bv, bp = st.bp, bi = st.bi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, bv, off);
    const int op = __shfl_xor_sync(FULL, bp, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (ov > bv || (ov == bv && (op < bp || (op == bp && oi > bi)))) {
      bv = ov;
      bp = op;
      bi = oi;
    }
  }
  if (t == 0) {
    o_score[prob] = bv;
    o_i[prob] = bv > 0 ? bi : 0;
    o_j[prob] = bv > 0 ? bp + 2 - bi : 0;
    o_steps[prob] = nsteps;
    o_blocks[prob] = nblk;
  }
}

template <int W, bool TRACE>
void launch(const FillParams& P, const int8_t* a, const int32_t* alen,
            int la, const int8_t* b, const int32_t* blen, int lb, int B,
            int max_blocks, int32_t* o_score, int32_t* o_i, int32_t* o_j,
            int32_t* o_steps, int32_t* o_blocks, uint32_t* masks,
            uint32_t* dirs, int32_t* iheads, int32_t* rprevs,
            cudaStream_t st) {
  fill_kernel<W, TRACE><<<B, 32, 0, st>>>(
      P, a, alen, la, b, blen, lb, max_blocks, o_score, o_i, o_j, o_steps,
      o_blocks, masks, dirs, iheads, rprevs);
}

}  // namespace

extern "C" int fill_launch(const void* a, const void* alen, int la,
                           const void* b, const void* blen, int lb, int B,
                           int W, int max_blocks, int trace,
                           const void* params, void* o_score, void* o_i,
                           void* o_j, void* o_steps, void* o_blocks,
                           void* masks, void* dirs, void* iheads,
                           void* rprevs, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  FillParams P;
  std::memcpy(&P, params, sizeof(P));
  auto A = static_cast<const int8_t*>(a);
  auto Bs = static_cast<const int8_t*>(b);
  auto al = static_cast<const int32_t*>(alen);
  auto bl = static_cast<const int32_t*>(blen);
  auto os = static_cast<int32_t*>(o_score);
  auto oi = static_cast<int32_t*>(o_i);
  auto oj = static_cast<int32_t*>(o_j);
  auto on = static_cast<int32_t*>(o_steps);
  auto ob = static_cast<int32_t*>(o_blocks);
  auto m = static_cast<uint32_t*>(masks);
  auto d = static_cast<uint32_t*>(dirs);
  auto ih = static_cast<int32_t*>(iheads);
  auto rp = static_cast<int32_t*>(rprevs);
  auto st = static_cast<cudaStream_t>(stream);
#define FILL_CASE(WW, TT)                                                   \
  launch<WW, TT>(P, A, al, la, Bs, bl, lb, B, max_blocks, os, oi, oj, on, \
                 ob, m, d, ih, rp, st)
  if (W == 64) {
    if (trace) FILL_CASE(64, true); else FILL_CASE(64, false);
  } else if (W == 32) {
    if (trace) FILL_CASE(32, true); else FILL_CASE(32, false);
  } else if (W == 16) {
    if (trace) FILL_CASE(16, true); else FILL_CASE(16, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef FILL_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
