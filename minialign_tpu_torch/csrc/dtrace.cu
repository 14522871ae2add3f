// Device traceback walk, one warp per problem.
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
// What bounds it: one walk's serial chain of moves (the engine's traced
// launches hold few problems). The first version made one to three
// dependent reads of device memory a move (the trace of a B=128 x 20 kb
// fill is ~330 MB, past the L2). This design takes every read of the chain out
// of device memory and gives the common move, a diagonal one, a short
// loop of its own; what is left is the state machine's dependent
// branches and integer ops on one warp with nothing to overlap them
// (~250-275 cycles a move on an H100, against ~950-1,400 before):
// - The whole warp runs the walk, every lane the same moves, so that all
//   32 lanes stage the trace: the walk consumes the 32-step blocks of its
//   trace in descending order, and a block (2 KB of code words and its
//   direction word) is copied into shared memory with 16-byte cp.async
//   copies, 4 a lane, double-buffered: the next-older block is in flight
//   while the walk reads the current one. The current block's direction
//   word sits in a register. (One thread issuing all 128 copies itself
//   was 1.17x slower a move on the card.)
// - When d_tail finds no vertical gap it takes d_head's test of the same
//   cell at once, without a second read and a second pass of the loop;
//   a run of diagonal moves (most moves at ~12% error) is an inner loop
//   of one read, one mask test and the move each, its ops emitted as one
//   run.
// - The ihead at the max is O(1): the fill's ihead at the start of the
//   max's block plus the right moves of that block up to the max.
// - Every lane stores the same entry byte to the same address, so the
//   walk has no branch on the lane.
// - One warp per thread block, so the walks spread over the SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 32;
constexpr int LEN_CAP = 63;
constexpr int OP_D = 1, OP_R = 2, OP_X = 3;
// bits of a 6-bit cell code (dp/band.py M_*; math.h owns the M_E name)
constexpr int BIT_GFA = 0, BIT_F = 1, BIT_GFB = 2, BIT_E = 3, BIT_FO = 4,
              BIT_EO = 5;
constexpr int GAP_BITS = (1 << BIT_F) | (1 << BIT_GFA) | (1 << BIT_E) |
                         (1 << BIT_GFB);
constexpr int NSUM = 14;
constexpr int BLOCK_WORDS = BLK * 16;   // code words of one trace block

struct TraceParams {
  int W, model, gi, ge, gfa, gfb, gfa_eff, gfb_eff;
};

struct Emitter {
  uint8_t* rle;
  int T, n_ent, op, len, n_ops;
  __device__ void flush() {
    if (len > 0 && n_ent < T) {
      rle[n_ent++] = (uint8_t)(op | (len << 2));   // every lane, one byte
      n_ops += len;
    }
    len = 0;
  }
  __device__ __forceinline__ void push1(int o) {   // push(o, 1)
    if (len > 0 && o == op && len < LEN_CAP) {
      ++len;
    } else {
      flush();
      op = o;
      len = 1;
    }
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

// A trace block into shared memory: its 2 KB of code words as 128
// 16-byte cp.async copies, 4 a lane, and its direction word, committed
// as one group
__device__ __forceinline__ void copy_block(uint32_t* dst, uint32_t* dword,
                                           const uint32_t* src,
                                           const uint32_t* dsrc, int lane) {
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  for (int k = lane; k < BLOCK_WORDS / 4; k += 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     sdst + 16 * k),
                 "l"(src + 4 * k)
                 : "memory");
  if (lane == 0)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dword)),
                 "l"(dsrc)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

__global__ void __launch_bounds__(32)
dtrace_kernel(TraceParams P, const uint32_t* __restrict__ masks,
              const uint32_t* __restrict__ dirs,
              const int32_t* __restrict__ iheads,
              const int32_t* __restrict__ score,
              const int32_t* __restrict__ ai,
              const int32_t* __restrict__ bj, int NB,
              uint8_t* __restrict__ rle, int T, int B,
              int32_t* __restrict__ summ) {
  // trace blocks cb (walked) and cb - 1 (in flight) in buf[cb & 1] and
  // buf[(cb - 1) & 1], their direction words in dws; block cb's in dcur
  __shared__ __align__(16) uint32_t buf[2][BLOCK_WORDS];
  __shared__ uint32_t dws[2];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int W = P.W;
  const uint32_t* m = masks + (size_t)b * NB * BLOCK_WORDS;
  const uint32_t* dw = dirs + (size_t)b * NB;
  int cb = -1;
  uint32_t dcur = 0;
  // make block nb current (the whole warp calls it, with one nb): the
  // walk only ever steps to the next-older block, which is in flight
  auto advance = [&](int nb) {
    if (nb != cb - 1) {
      wait_copies();
      copy_block(buf[nb & 1], &dws[nb & 1], m + (size_t)nb * BLOCK_WORDS,
                 dw + nb, lane);
    }
    wait_copies();
    dcur = dws[nb & 1];
    if (nb > 0)
      copy_block(buf[(nb - 1) & 1], &dws[(nb - 1) & 1],
                 m + (size_t)(nb - 1) * BLOCK_WORDS, dw + nb - 1, lane);
    cb = nb;
  };
  auto code = [&](int pp, int q) -> int {
    if ((pp >> 5) != cb) advance(pp >> 5);
    const uint32_t w = buf[cb & 1][(pp & 31) * 16 + (q & 15)];
    return (int)((w >> ((q >> 4) << 3)) & 0x3F);
  };
  auto dir = [&](int pp) -> int {
    if (pp < 0) return 0;
    if ((pp >> 5) != cb) advance(pp >> 5);
    return (int)((dcur >> (pp & 31)) & 1);
  };

  Emitter em{rle + (size_t)b * T, T, 0, 0, 0, 0};
  int dcnt = 0, agcnt = 0, bgcnt = 0, n_open = 0, n_ext = 0, gf_pen = 0,
      e_pen = 0, bad = 0;
  const int sc = score[b];
  int i = ai[b], j = bj[b];

  if (!(sc <= 0 || (i == 0 && j == 0))) {
    int pp = i + j - 2;
    // ihead at band pp: the fill's ihead at the start of pp's block plus
    // the right moves of that block's steps up to pp
    int ihead = iheads[(size_t)b * NB];
    if (pp >= NB * BLK) {
      bad = 1;
    } else if (pp >= 0) {
      const int blk = pp >> 5;
      const int rem = (pp & 31) + 1;
      const uint32_t msk = rem >= 32 ? 0xffffffffu : ((1u << rem) - 1);
      ihead = iheads[(size_t)b * NB + blk] + rem - __popc(dw[blk] & msk);
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
      // d_tail tests a vertical gap; without one it takes d_head's test
      // of the same cell, with no move in between
      bool moved = false;
      if (!head) {
        if (((c >> BIT_F) | (c >> BIT_GFA)) & 1) {
          const int fb =
              (((c >> BIT_F) & ~(c >> BIT_GFA)) | (c >> BIT_FO)) & 1;
          if (!fb) {              // one-base gf gap on the query side
            em.push1(OP_D);
            bgcnt += 1;
            gf_pen += P.gfa_eff;
            q -= dir(pp) == 1 ? 0 : 1;
            j -= 1;
            pp -= 1;
          } else {
            n_open += 1;
            while (true) {
              em.push1(OP_D);
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
          moved = true;
        } else {
          head = true;
        }
      }
      if (!moved) {
        if (((c >> BIT_E) | (c >> BIT_GFB)) & 1) {
          const int eb =
              (((c >> BIT_E) & ~(c >> BIT_GFB)) | (c >> BIT_EO)) & 1;
          if (!eb) {              // one-base gf gap on the ref side
            em.push1(OP_R);
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
              em.push1(OP_R);
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
        } else {
          // a diagonal move, then more while the next cell is in the band
          // and opens no gap (d_tail, then d_head, would take the diagonal
          // there too); any other case goes back to the loop, which reads
          // the cell again. (Reading the next cell ahead, before this one
          // is tested, was 1.2x slower on the card.)
          int run = 0;
          while (true) {              // block pp >> 5 is the current one
            ++run;
            int d0, d1;
            if (pp & 31) {            // pp and pp - 1 in one direction word
              const uint32_t w = dcur >> ((pp & 31) - 1);
              d0 = (w >> 1) & 1;
              d1 = w & 1;
            } else {
              d0 = dir(pp);
              d1 = dir(pp - 1);       // may step to the next block
            }
            q += d0 - (d1 ^ 1);
            i -= 1;
            j -= 1;
            pp -= 2;
            if (i == 0 || j == 0 || (unsigned)q >= (unsigned)W) break;
            if (code(pp, q) & GAP_BITS) break;
          }
          em.push(OP_X, run);
          dcnt += run;
          head = false;
        }
      }
      if (q < -1 || q > W) {      // defensive post-move band check
        bad = 1;
        break;
      }
    }
  }
  em.flush();
  wait_copies();   // no copy outlives the block
  const int vals[NSUM] = {em.n_ops, em.n_ent, bad, dcnt, agcnt, bgcnt,
                          n_open, n_ext, gf_pen, e_pen, sc, ai[b], bj[b],
                          0};
  if (lane == 0)
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
  dtrace_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(dirs),
      static_cast<const int32_t*>(iheads),
      static_cast<const int32_t*>(score), static_cast<const int32_t*>(ai),
      static_cast<const int32_t*>(bj), NB, static_cast<uint8_t*>(rle), T, B,
      static_cast<int32_t*>(summ));
  return (int)cudaGetLastError();
}
