// Store-window gather: out[b, col] for col < L from the flat device
// sequence store, one block per problem.
//
// Replaces minialign_tpu/dp/pallas_gather.py:make_gather (Pallas, TPU)
// together with its XLA twin FillEngine._gather_fn
// (minialign_tpu/extend.py:499-523), whose contract it implements,
// circular wrap included:
//   idx  = start + col;  idxw = wrap > 0 ? idx mod wrap : idx
//   ok   = col < cap && (wrap > 0 || idx < seglen) && seglen > 0
//   out  = ok ? store[base + clip(idxw, 0, seglen - 1)] : NCODE
// (the seglen > 0 term only keeps an empty segment from reading
// store[base - 1]; every real segment has seglen > 0)
// and is held against minialign_tpu_torch/dp/cuda_gather.py:gather_plain.
//
// What bounds it: bytes. Each thread copies four neighbouring columns
// and stores them as one 32-bit word, so a warp reads 128 consecutive
// store bytes and writes 128 consecutive output bytes per iteration. The
// TPU kernel's 8-row aligned DMA and lane-roll cascade existed only
// because Mosaic needs aligned DMA offsets; here any byte offset loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NCODE = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ int8_t pick(const int8_t* __restrict__ store,
                                       long long base, long long idx,
                                       int cap, int seglen, int wrap,
                                       int col) {
  long long idxw = idx;
  if (wrap > 0) {
    idxw = idx % wrap;
    if (idxw < 0) idxw += wrap;
  }
  const bool ok = col < cap && (wrap > 0 || idx < seglen) && seglen > 0;
  if (!ok) return NCODE;
  long long safe = idxw < 0 ? 0 : idxw;
  if (safe > seglen - 1) safe = seglen - 1;
  return store[base + safe];
}

__global__ void __launch_bounds__(THREADS)
gather_kernel(const int8_t* __restrict__ store,
              const int64_t* __restrict__ base,
              const int32_t* __restrict__ start,
              const int32_t* __restrict__ cap,
              const int32_t* __restrict__ seglen,
              const int32_t* __restrict__ wrap, int L,
              int8_t* __restrict__ out) {
  const int b = blockIdx.x;
  const long long bs = base[b];
  const int st = start[b], cp = cap[b], sl = seglen[b], wr = wrap[b];
  uint32_t* row = reinterpret_cast<uint32_t*>(out + (size_t)b * L);
  for (int w = threadIdx.x; w < L / 4; w += THREADS) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 4 * w + k;
      const int8_t c = pick(store, bs, (long long)st + col, cp, sl, wr, col);
      v |= (uint32_t)(uint8_t)c << (8 * k);
    }
    row[w] = v;
  }
}

}  // namespace

// L must be a multiple of 4 (the wrapper rounds rows to 128 bytes).
extern "C" int gather_launch(const void* store, const void* base,
                             const void* start, const void* cap,
                             const void* seglen, const void* wrap, int B,
                             int L, void* out, void* stream) {
  if (L % 4 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return (int)cudaSuccess;
  gather_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(store), static_cast<const int64_t*>(base),
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(cap),
      static_cast<const int32_t*>(seglen), static_cast<const int32_t*>(wrap),
      L, static_cast<int8_t*>(out));
  return (int)cudaGetLastError();
}
