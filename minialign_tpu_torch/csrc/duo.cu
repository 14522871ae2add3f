// The up window of a fused down+up ("duo") batch, computed on the device
// from the down fill's result, so that the up gather, the traced up fill
// and the walk follow the down fill on one stream with no read-back in
// between.
//
// Replaces the up-window arithmetic of minialign_tpu/extend.py:675-737
// (FillEngine._duo_fn, :703 and :710-722, and the three down rows it
// appends to the summary, :731-734), and is held against
// minialign_tpu_torch/dp/duo.py:duo_window_plain. For problem b:
//   tp0   = clip(cp0 + max_i, 1, rlen),  tp1 = clip(cp1 + max_j, 1, qlen)
//   ok    = max_score > 0
//   lna_u = min(2 tp1 + CAPU_ADD, tp0) * ok,  lnb_u = tp1 * ok
// and the up batch's packed descriptor block (dp/cuda_gather.py:pack_desc,
// R = 2B rows: side a's B rows, then side b's) gets
//   row b     : base rvbase, start rlen - tp0, cap = elen = lna_u,
//               seglen rlen, wrap 0   (the reference's reverse strand)
//   row B + b : base qub,    start qlen - tp1, cap = elen = lnb_u,
//               seglen qlen, wrap 0   (the read's other strand)
// The base stays a separate int64 word and the gather adds the start in
// 64 bits, so rvbase + rlen - tp0 is never folded into an int32 (the
// TPU kernel's offa_u was int32). A failed down (ok = 0) gets empty up
// windows: all-NCODE rows whose fill scores 0 at once.
//
// One thread a problem; a few hundred bytes a batch, so the launch is
// the cost (bound: bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr long long CAPU_ADD = 4 * 64 + 2 * 96 + 64;   // _slice_cap(.., 64)

__device__ __forceinline__ long long clip(long long x, long long lo,
                                          long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// geom: the packed geometry block of B problems (dp/duo.py:pack_geom),
// int32 words: rvbase (int64) [2B], qub (int64) [2B], then rlen, qlen,
// cp0, cp1 [B each]. desc: the up block, 7 int32 words a row (base's
// two, then start, cap, seglen, wrap, elen) over R = 2B rows.
// dsum: the down rows (max_score, max_i, max_j), row stride ld.
__global__ void __launch_bounds__(THREADS)
duo_window_kernel(const int32_t* __restrict__ score,
                  const int32_t* __restrict__ max_i,
                  const int32_t* __restrict__ max_j,
                  const int32_t* __restrict__ geom, int B,
                  int32_t* __restrict__ desc, int32_t* __restrict__ dsum,
                  long long ld) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const long long* g64 = reinterpret_cast<const long long*>(geom);
  const long long rvbase = g64[b], qub = g64[B + b];
  const int32_t* g32 = geom + 4 * B;
  const long long rlen = g32[b], qlen = g32[B + b];
  const long long cp0 = g32[2 * B + b], cp1 = g32[3 * B + b];
  const int sc = score[b], mi = max_i[b], mj = max_j[b];
  const long long tp0 = clip(cp0 + mi, 1, rlen);
  const long long tp1 = clip(cp1 + mj, 1, qlen);
  const long long ok = sc > 0;
  const long long t = 2 * tp1 + CAPU_ADD;
  const int lna = (int)((t < tp0 ? t : tp0) * ok);
  const int lnb = (int)(tp1 * ok);
  const int R = 2 * B;
  long long* base = reinterpret_cast<long long*>(desc);
  int32_t* f = desc + 2 * R;                 // start, cap, seglen, wrap, elen
  base[b] = rvbase;
  base[B + b] = qub;
  f[b] = (int)(rlen - tp0);
  f[B + b] = (int)(qlen - tp1);
  f[R + b] = lna;
  f[R + B + b] = lnb;
  f[2 * R + b] = (int)rlen;
  f[2 * R + B + b] = (int)qlen;
  f[3 * R + b] = 0;
  f[3 * R + B + b] = 0;
  f[4 * R + b] = lna;
  f[4 * R + B + b] = lnb;
  dsum[b] = sc;
  dsum[ld + b] = mi;
  dsum[2 * ld + b] = mj;
}

}  // namespace

// B problems; geom, desc and dsum as above, every pointer 8-byte aligned
// where it holds int64 words.
extern "C" int duo_window_launch(const void* score, const void* max_i,
                                 const void* max_j, const void* geom, int B,
                                 void* desc, void* dsum, long long ld,
                                 void* stream) {
  if (B < 0 || ld < B || ((uintptr_t)geom | (uintptr_t)desc) % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  duo_window_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(score), static_cast<const int32_t*>(max_i),
      static_cast<const int32_t*>(max_j), static_cast<const int32_t*>(geom),
      B, static_cast<int32_t*>(desc), static_cast<int32_t*>(dsum), ld);
  return (int)cudaGetLastError();
}
