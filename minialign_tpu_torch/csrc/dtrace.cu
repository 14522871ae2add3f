// Device traceback walk, one thread per problem.
//
// Replaces minialign_tpu/dp/dtrace.py:make_device_traceback (an XLA
// while-loop on the TPU) and is held against
// minialign_tpu_torch/dp/dtrace.py:dtrace_plain: the same decoded paths
// and summary rows (SUMMARY_ROWS there). The walk is gaba's trace_core
// state machine (gaba.c:3123-3207) as minialign_tpu/dp/traceback.py
// traceback_one runs it: horizontal (R) gaps are tested in the d_head
// state, vertical (D) gaps in the d_tail state; a gap head takes the
// one-base gf branch when its folded bit is clear, else an affine run.
//
// Output: backward run-length entries op | len << 2 (op 1 'D', 2 'R',
// 3 diagonal), one maximal run of an op per entry, split every 63 ops;
// the rows rle[b][0 .. n_ent) of a (B, T) uint8 buffer. The XLA walker
// chunked runs by its CHAIN probe depth instead; the decoded ops are the
// same.
//
// What bounds it: a serial chain of dependent loads (one cell code and
// sometimes a dir word per move) per problem, i.e. memory latency. Each
// walk runs on lane 0 of its own warp: walks branch differently at
// every move, so 32 walks packed into one warp serialize on divergence
// (and B=128 walks fit one SM); a warp each spreads them over the SMs.
// The codes of a walk move through a few cache lines, so most loads hit
// L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 32;
constexpr int LEN_CAP = 63;
constexpr int OP_D = 1, OP_R = 2, OP_X = 3;
// bits of a 6-bit cell code (dp/band.py M_*; math.h owns the M_E name)
constexpr int BIT_GFA = 0, BIT_F = 1, BIT_GFB = 2, BIT_E = 3, BIT_FO = 4,
              BIT_EO = 5;
constexpr int NSUM = 14;
constexpr int WALKS = 4;   // problems (warps) per block

struct TraceParams {
  int W, model, gi, ge, gfa, gfb, gfa_eff, gfb_eff;
};

struct Emitter {
  uint8_t* rle;
  int T, n_ent, op, len, n_ops;
  __device__ void flush() {
    if (len > 0 && n_ent < T) {
      rle[n_ent++] = (uint8_t)(op | (len << 2));
      n_ops += len;
    }
    len = 0;
  }
  __device__ void push(int o, int n) {
    while (n > 0) {
      if (len > 0 && o == op && len < LEN_CAP) {
        const int take = min(n, LEN_CAP - len);
        len += take;
        n -= take;
      } else {
        flush();
        op = o;
        len = min(n, LEN_CAP);
        n -= len;
      }
    }
  }
};

__global__ void dtrace_kernel(TraceParams P,
                              const uint32_t* __restrict__ masks,
                              const uint32_t* __restrict__ dirs,
                              const int32_t* __restrict__ iheads,
                              const int32_t* __restrict__ score,
                              const int32_t* __restrict__ ai,
                              const int32_t* __restrict__ bj, int B, int NB,
                              uint8_t* __restrict__ rle, int T,
                              int32_t* __restrict__ summ) {
  const int b = blockIdx.x * WALKS + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) != 0 || b >= B) return;  // lane 0 walks
  const int W = P.W;
  const uint32_t* m = masks + (size_t)b * NB * BLK * 16;
  const uint32_t* dw = dirs + (size_t)b * NB;
  auto code = [&](int pp, int q) -> int {
    const uint32_t w = m[(size_t)pp * 16 + (q & 15)];
    return (int)((w >> ((q >> 4) << 3)) & 0x3F);
  };
  auto dir = [&](int pp) -> int {
    return pp < 0 ? 0 : (int)((dw[pp >> 5] >> (pp & 31)) & 1);
  };

  Emitter em{rle + (size_t)b * T, T, 0, 0, 0, 0};
  int dcnt = 0, agcnt = 0, bgcnt = 0, n_open = 0, n_ext = 0, gf_pen = 0,
      e_pen = 0, bad = 0;
  const int sc = score[b];
  int i = ai[b], j = bj[b];

  if (!(sc <= 0 || (i == 0 && j == 0))) {
    int pp = i + j - 2;
    // ihead at band pp: the fill's first ihead plus the right moves of
    // steps 0 .. pp
    int ihead = iheads[(size_t)b * NB];
    if (pp >= NB * BLK) {
      bad = 1;
    } else if (pp >= 0) {
      const int nfull = pp >> 5;
      for (int k = 0; k < nfull; ++k) ihead += BLK - __popc(dw[k]);
      const int rem = (pp & 31) + 1;
      const uint32_t msk = rem >= 32 ? 0xffffffffu : ((1u << rem) - 1);
      ihead += rem - __popc(dw[nfull] & msk);
    }
    int q = ihead - i;
    if (q < 0 || q >= W) bad = 1;
    bool head = true;
    while (!bad && (i > 0 || j > 0)) {
      if (i == 0) {             // leading query-side gap: whole run priced
        em.push(OP_D, j);
        bgcnt += j;
        if (P.model == 2 && P.gfa * j < P.gi + j * P.ge) {
          gf_pen += P.gfa * j;
        } else {
          n_open += 1;
          n_ext += j;
        }
        j = 0;
        break;
      }
      if (j == 0) {
        em.push(OP_R, i);
        agcnt += i;
        const int aff = P.gi + i * P.ge;
        if (P.model == 2 && P.gfb * i < aff) {
          gf_pen += P.gfb * i;
          e_pen += P.gfb * i;
        } else {
          n_open += 1;
          n_ext += i;
          e_pen += aff;
        }
        i = 0;
        break;
      }
      if (q < 0 || q >= W) {
        bad = 1;
        break;
      }
      int c = code(pp, q);
      if (head) {
        if (((c >> BIT_E) | (c >> BIT_GFB)) & 1) {
          const int eb =
              (((c >> BIT_E) & ~(c >> BIT_GFB)) | (c >> BIT_EO)) & 1;
          if (!eb) {              // one-base gf gap on the ref side
            em.push(OP_R, 1);
            agcnt += 1;
            gf_pen += P.gfb_eff;
            e_pen += P.gfb_eff;
            q += dir(pp);
            i -= 1;
            pp -= 1;
          } else {                // affine run
            n_open += 1;
            e_pen += P.gi;
            while (true) {
              em.push(OP_R, 1);
              agcnt += 1;
              n_ext += 1;
              e_pen += P.ge;
              q += dir(pp);
              i -= 1;
              pp -= 1;
              if (i <= 0) break;
              if (q < 0 || q >= W) {
                bad = 1;
                break;
              }
              c = code(pp, q);
              const int hb = ((c >> BIT_E) | (c >> BIT_GFB)) & 1;
              const int e2 =
                  (((c >> BIT_E) & ~(c >> BIT_GFB)) | (c >> BIT_EO)) & 1;
              if (!hb && e2) break;
            }
            if (bad) break;
          }
        } else {                  // diagonal
          em.push(OP_X, 1);
          dcnt += 1;
          q += dir(pp) - (dir(pp - 1) == 0 ? 1 : 0);
          i -= 1;
          j -= 1;
          pp -= 2;
          head = false;
        }
      } else {
        if (((c >> BIT_F) | (c >> BIT_GFA)) & 1) {
          const int fb =
              (((c >> BIT_F) & ~(c >> BIT_GFA)) | (c >> BIT_FO)) & 1;
          if (!fb) {              // one-base gf gap on the query side
            em.push(OP_D, 1);
            bgcnt += 1;
            gf_pen += P.gfa_eff;
            q -= dir(pp) == 1 ? 0 : 1;
            j -= 1;
            pp -= 1;
          } else {
            n_open += 1;
            while (true) {
              em.push(OP_D, 1);
              bgcnt += 1;
              n_ext += 1;
              q -= dir(pp) == 1 ? 0 : 1;
              j -= 1;
              pp -= 1;
              if (j <= 0) break;
              if (q < 0 || q >= W) {
                bad = 1;
                break;
              }
              c = code(pp, q);
              const int vb = ((c >> BIT_F) | (c >> BIT_GFA)) & 1;
              const int f2 =
                  (((c >> BIT_F) & ~(c >> BIT_GFA)) | (c >> BIT_FO)) & 1;
              if (!vb && f2) break;
            }
            if (bad) break;
          }
        } else {
          head = true;            // fall through to the head test
          continue;
        }
      }
      if (q < -1 || q > W) {      // defensive post-move band check
        bad = 1;
        break;
      }
    }
  }
  em.flush();
  const int vals[NSUM] = {em.n_ops, em.n_ent, bad, dcnt, agcnt, bgcnt,
                          n_open, n_ext, gf_pen, e_pen, sc, ai[b], bj[b],
                          0};
  for (int r = 0; r < NSUM; ++r) summ[(size_t)r * B + b] = vals[r];
}

}  // namespace

extern "C" int dtrace_launch(const void* masks, const void* dirs,
                             const void* iheads, const void* score,
                             const void* ai, const void* bj, int B, int NB,
                             const void* params, void* rle, void* summ,
                             int T, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const TraceParams P = *static_cast<const TraceParams*>(params);
  dtrace_kernel<<<(B + WALKS - 1) / WALKS, WALKS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(dirs),
      static_cast<const int32_t*>(iheads),
      static_cast<const int32_t*>(score), static_cast<const int32_t*>(ai),
      static_cast<const int32_t*>(bj), B, NB, static_cast<uint8_t*>(rle), T,
      static_cast<int32_t*>(summ));
  return (int)cudaGetLastError();
}
