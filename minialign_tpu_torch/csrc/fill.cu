// Adaptive-banded semi-global SWG fill, one warp per problem.
//
// Replaces minialign_tpu/dp/pallas_fill.py:make_fill_pallas (Pallas, TPU;
// semantics twin minialign_tpu/dp/band.py:make_fill) and is held against
// minialign_tpu_torch/dp/band.py:fill_plain, bit for bit.
//
// Band geometry: lane q of the band at anti-diagonal step p holds cell
// (i, j) = (ihead - q, p + 2 - ihead + q). A warp holds the W lanes of
// one problem: W=64 gives thread t lanes t and t+32, W=32 lane t, W=16
// lane t on threads 0-15 (16-31 idle). The one-lane rolls of the band
// (roll_q in band.py) are __shfl_up/down_sync with the floor rolled in;
// the step max is a butterfly reduction that keeps the lowest lane on
// ties. Characters are read straight from the gathered (B, L) int8 rows:
// a[i-1] and b[j-1], NCODE outside the row.
//
// What bounds it: a chain of dependent shuffles per step (direction
// broadcast -> lane roll -> max) with one warp per problem, i.e. latency,
// not bytes or arithmetic. The kernel keeps all band state in registers,
// reads 2 bytes a lane a step (L1-resident rows), and writes 64 bytes of
// cell codes a step in trace mode, coalesced by threads 0-15. Many
// problems in flight (one warp each, 4 per block) hide the latency.
//
// Trace layout (the JAX package's, unchanged): masks[b][blk][s][r] holds
// the 6-bit codes of lanes r + 16 f at bits [8 f, 8 f + 6).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 32;
constexpr int NCODE = 4;
constexpr int TAIL_N = 96;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;   // problems per block

struct FillParams {
  int sub[25];   // sub[b * 5 + a]: query base b against ref base a
  int gi, ge, gfa_eff, gfb_eff, gfa, gfb, model, floor_, xdrop;
};

template <int W>
struct Lanes {
  static constexpr int NL = W == 64 ? 2 : 1;
};

// out[q] = x[q + 1], fill at q = W - 1
template <int W>
__device__ __forceinline__ void roll_up(const int* x, int* out, int fill,
                                        int t) {
  if constexpr (W == 64) {
    int v0 = __shfl_down_sync(FULL, x[0], 1);
    int v1 = __shfl_down_sync(FULL, x[1], 1);
    int w = __shfl_sync(FULL, x[1], 0);
    out[0] = t == 31 ? w : v0;
    out[1] = t == 31 ? fill : v1;
  } else {
    int v = __shfl_down_sync(FULL, x[0], 1);
    out[0] = t >= W - 1 ? fill : v;
  }
}

// out[q] = x[q - 1], fill at q = 0
template <int W>
__device__ __forceinline__ void roll_dn(const int* x, int* out, int fill,
                                        int t) {
  if constexpr (W == 64) {
    int v0 = __shfl_up_sync(FULL, x[0], 1);
    int v1 = __shfl_up_sync(FULL, x[1], 1);
    int w = __shfl_sync(FULL, x[0], 31);
    out[0] = t == 0 ? fill : v0;
    out[1] = t == 0 ? w : v1;
  } else {
    int v = __shfl_up_sync(FULL, x[0], 1);
    out[0] = t == 0 ? fill : v;
  }
}

template <int W, bool TRACE>
__global__ void __launch_bounds__(WARPS * 32)
fill_kernel(FillParams P, const int8_t* __restrict__ a,
            const int32_t* __restrict__ alen, int LA,
            const int8_t* __restrict__ b, const int32_t* __restrict__ blen,
            int LB, int B, int max_blocks, int32_t* __restrict__ o_score,
            int32_t* __restrict__ o_i, int32_t* __restrict__ o_j,
            int32_t* __restrict__ o_steps, int32_t* __restrict__ o_blocks,
            uint32_t* __restrict__ masks, uint32_t* __restrict__ dirs,
            int32_t* __restrict__ iheads, int32_t* __restrict__ rprevs) {
  constexpr int NL = Lanes<W>::NL;
  constexpr int c = W / 2;
  __shared__ int sub[25];
  if (threadIdx.x < 25) sub[threadIdx.x] = P.sub[threadIdx.x];
  __syncthreads();

  const int t = threadIdx.x & 31;
  const int prob = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (prob >= B) return;  // warp-uniform
  const int8_t* arow = a + (size_t)prob * LA;
  const int8_t* brow = b + (size_t)prob * LB;
  const int fl = P.floor_;
  const int gi = P.gi, ge = P.ge, gfa = P.gfa_eff, gfb = P.gfb_eff;

  int q[NL];
  for (int k = 0; k < NL; ++k) q[k] = t + 32 * k;

  // band state at p = -1 (band.py _init_band)
  int g1b = -gi - ge, g1a = -gi - ge;
  if (P.model == 2) {
    g1b = max(g1b, -P.gfb);
    g1a = max(g1a, -P.gfa);
  }
  g1b = max(g1b, fl);
  g1a = max(g1a, fl);
  int S[NL], Sp[NL], E[NL], F[NL];
  for (int k = 0; k < NL; ++k) {
    S[k] = q[k] == c - 1 ? g1b : (q[k] == c ? g1a : fl);
    E[k] = q[k] == c - 1 ? g1b : fl;
    F[k] = q[k] == c ? g1a : fl;
    Sp[k] = q[k] == c ? 0 : fl;
  }
  int ihead = c, rprev = 0, p = -1;
  int gmax = 0, gi_ = 0, gj_ = 0, nsteps = 0, cdrop = -128, nblk = 0;
  const int plim = min(alen[prob] + blen[prob] + 2 * TAIL_N,
                       max_blocks * BLK - 2);
  // owner of the center lane cW = W / 2 (x-drop accumulator)
  constexpr int tc = W == 64 ? 0 : c;
  constexpr int kc = W == 64 ? 1 : 0;

  for (int blk = 0; blk < max_blocks; ++blk) {
    size_t bi = (size_t)prob * max_blocks + blk;
    if (TRACE && t == 0) {
      iheads[bi] = ihead;
      rprevs[bi] = rprev;
    }
    uint32_t dirbits = 0;
    for (int s = 0; s < BLK; ++s) {
      // direction: down iff S[W-1] > S[0], alternating during ramp-in
      const int s0 = __shfl_sync(FULL, S[0], 0);
      const int sW = __shfl_sync(FULL, S[NL - 1], (W - 1) & 31);
      const bool edge_ok = (ihead - (W - 1) >= 0) && (p + 2 - ihead >= 0);
      const bool down = edge_ok ? (sW > s0) : (((p + 1) & 1) == 1);

      int SE[NL], EE[NL], SF[NL], FF[NL], Sd[NL];
      if (down) {
        roll_up<W>(S, SE, fl, t);
        roll_up<W>(E, EE, fl, t);
        for (int k = 0; k < NL; ++k) {
          SF[k] = S[k];
          FF[k] = F[k];
        }
      } else {
        roll_dn<W>(S, SF, fl, t);
        roll_dn<W>(F, FF, fl, t);
        for (int k = 0; k < NL; ++k) {
          SE[k] = S[k];
          EE[k] = E[k];
        }
      }
      const int sh = (down ? 1 : 0) - rprev;
      if (sh == 1) {
        roll_up<W>(Sp, Sd, fl, t);
      } else if (sh == -1) {
        roll_dn<W>(Sp, Sd, fl, t);
      } else {
        for (int k = 0; k < NL; ++k) Sd[k] = Sp[k];
      }

      const int ihn = ihead + (down ? 0 : 1);
      const int pn = p + 1;
      int Sn[NL], En[NL], Fn[NL], cand[NL];
      uint32_t code[NL];
      for (int k = 0; k < NL; ++k) {
        const int i = ihn - q[k];
        const int j = pn + 2 - i;
        const int ai = i - 1, bj = j - 1;
        const int ac = (ai >= 0 && ai < LA) ? arow[ai] : NCODE;
        const int bc = (bj >= 0 && bj < LB) ? brow[bj] : NCODE;
        int e = max(SE[k] - gi, EE[k]) - ge;
        int f = max(SF[k] - gi, FF[k]) - ge;
        int sn = max(Sd[k] + sub[bc * 5 + ac],
                     max(max(e, SE[k] - gfb), max(f, SF[k] - gfa)));
        sn = max(sn, fl);
        if (TRACE) {
          code[k] = (uint32_t)(sn == SF[k] - gfa) |
                    ((uint32_t)(sn == f) << 1) |
                    ((uint32_t)(sn == SE[k] - gfb) << 2) |
                    ((uint32_t)(sn == e) << 3) |
                    ((uint32_t)(sn - gi >= f) << 4) |
                    ((uint32_t)(sn - gi >= e) << 5);
        }
        // true boundary values on the first row / column
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
        if (W == 16 && t >= 16) sn = e = f = fl;  // idle half-warp
        Sn[k] = sn;
        En[k] = e;
        Fn[k] = f;
        cand[k] = (on_i0 || on_j0 || inv || (W == 16 && t >= 16)) ? fl : sn;
      }

      if (TRACE) {
        uint32_t v = code[0];
        if (NL == 2) v |= code[NL - 1] << 16;
        const uint32_t hi = __shfl_down_sync(FULL, v, 16);
        if (t < 16)
          masks[(bi * BLK + s) * 16 + t] = W == 16 ? v : (v | (hi << 8));
        dirbits |= (down ? 1u : 0u) << s;
      }

      // step max, lowest lane on ties
      int bv = cand[0], bq = q[0];
      if (NL == 2 && cand[NL - 1] > bv) {
        bv = cand[NL - 1];
        bq = q[NL - 1];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(FULL, bv, off);
        const int oq = __shfl_xor_sync(FULL, bq, off);
        if (ov > bv || (ov == bv && oq < bq)) {
          bv = ov;
          bq = oq;
        }
      }
      if (bv > gmax) {
        gmax = bv;
        gi_ = ihn - bq;
        gj_ = pn + 2 - gi_;
      }
      // saturating int8 center-lane drop accumulator (gaba.c:1650)
      const int dl = __shfl_sync(FULL, Sn[kc] - S[kc], tc);
      cdrop = min(max(cdrop - dl, -128), 127);

      for (int k = 0; k < NL; ++k) {
        Sp[k] = S[k];
        S[k] = Sn[k];
        E[k] = En[k];
        F[k] = Fn[k];
      }
      ihead = ihn;
      rprev = down ? 0 : 1;
      p = pn;
      ++nsteps;
    }
    if (TRACE && t == 0) dirs[bi] = dirbits;
    ++nblk;
    // X-drop test at block end (gaba.c:1738) + p-limit
    if (cdrop > P.xdrop - 128 || p >= plim) break;
  }
  if (t == 0) {
    o_score[prob] = gmax;
    o_i[prob] = gi_;
    o_j[prob] = gj_;
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
  dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  fill_kernel<W, TRACE><<<grid, block, 0, st>>>(
      P, a, alen, la, b, blen, lb, B, max_blocks, o_score, o_i, o_j,
      o_steps, o_blocks, masks, dirs, iheads, rprevs);
}

}  // namespace

extern "C" int fill_launch(const void* a, const void* alen, int la,
                           const void* b, const void* blen, int lb, int B,
                           int W, int max_blocks, int trace,
                           const void* params, void* o_score, void* o_i,
                           void* o_j, void* o_steps, void* o_blocks,
                           void* masks, void* dirs, void* iheads,
                           void* rprevs, void* stream) {
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
