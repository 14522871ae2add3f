// Store-window gather of both sides of a fill batch in one launch:
// out_s[b, col] for col < L_s from the flat device sequence store of
// side s (a: the reference, b: the reads).
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
// and is held against minialign_tpu_torch/dp/cuda_gather.py:
// gather_pair_plain (two gather_plain calls).
//
// What bounds it: bytes (each output byte written once, each selected
// store byte read once; no arithmetic to speak of). The design:
// - one launch for both sides; a CTA of 256 threads copies one 4 KB
//   chunk of one row (grid: rows of a then b, by chunks), so a
//   one-problem batch at 32 kb spreads over 16 CTAs;
// - a thread writes 16 output columns with one 16-byte store. When they
//   are 16 consecutive in-segment bytes, it reads the two aligned
//   16-byte words that cover them (ld.global.nc.v4) and shifts them into
//   place with funnel shifts: the Hopper form of the TPU kernel's
//   aligned DMA and roll cascade;
// - where a vector lies against the segment end, cap and wrap point is
//   worked out in 64-bit scalars from the chunk's first column (one
//   modulo per thread, none per byte); only a vector that straddles one
//   of them, starts before the segment or wraps more than once takes the
//   byte-wise path (pick), so the contract holds byte for byte;
// - the stores are padded with at least 16 NCODE bytes past a 16-byte
//   multiple (cuda_gather.pad_store), so the second aligned word of an
//   in-segment vector never leaves the allocation. The kernel still
//   tests that against the store's length and takes the byte-wise path
//   on an unpadded store.
// Measured on an H100 80GB HBM3 at a 700 W power limit (chip_smoke.py
// phase 2, kbench.py): 512 windows of 32 kb from a 10 MB store in
// 0.0098-0.0099 ms of device time against a bound of 0.0088 ms (bytes),
// ~2.97 TB/s; one problem a side at 40 / 20 kb in 0.0031 ms (launch
// latency).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NCODE = 4;
constexpr int THREADS = 256;
constexpr int VEC = 16;                   // columns a thread writes
constexpr int CHUNK = THREADS * VEC;      // columns a CTA writes
constexpr uint32_t NCODE4 = 0x04040404u;  // four NCODE bytes

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

// bytes r .. r + 15 of the 32 bytes lo:hi (little-endian words)
__device__ __forceinline__ uint4 window16(uint4 lo, uint4 hi, int r) {
  uint32_t x0 = lo.x, x1 = lo.y, x2 = lo.z, x3 = lo.w;
  uint32_t x4 = hi.x, x5 = hi.y, x6 = hi.z, x7 = hi.w;
  if (r & 8) {
    x0 = x2; x1 = x3; x2 = x4; x3 = x5; x4 = x6; x5 = x7;
  }
  if (r & 4) {
    x0 = x1; x1 = x2; x2 = x3; x3 = x4; x4 = x5;
  }
  const unsigned s = (r & 3) * 8;
  return make_uint4(__funnelshift_r(x0, x1, s), __funnelshift_r(x1, x2, s),
                    __funnelshift_r(x2, x3, s), __funnelshift_r(x3, x4, s));
}

// desc: the packed descriptor block of R = Ba + Bb rows (side a's rows,
// then side b's), int32 words: base (int64) [2R], then start, cap,
// seglen, wrap [R each] (cuda_gather.pack_desc; the fill's lengths
// follow and are not read here)
__global__ void __launch_bounds__(THREADS)
gather_pair_kernel(const int8_t* __restrict__ store_a, long long n_a,
                   const int8_t* __restrict__ store_b, long long n_b,
                   const int32_t* __restrict__ desc, int Ba, int R, int La,
                   int Lb, int8_t* __restrict__ out_a,
                   int8_t* __restrict__ out_b) {
  const int r = blockIdx.x;
  const bool side_b = r >= Ba;
  const int L = side_b ? Lb : La;
  const int chunk0 = blockIdx.y * CHUNK;
  if (chunk0 >= L) return;                  // past this side's rows
  const int col0 = chunk0 + threadIdx.x * VEC;
  const bool live = col0 < L;               // L is a multiple of 16
  const int8_t* store = side_b ? store_b : store_a;
  const long long n = side_b ? n_b : n_a;
  int8_t* row = side_b ? out_b + (size_t)(r - Ba) * Lb
                       : out_a + (size_t)r * La;
  const long long base = reinterpret_cast<const long long*>(desc)[r];
  const int start = desc[2 * R + r], cap = desc[3 * R + r];
  const int seglen = desc[4 * R + r], wrap = desc[5 * R + r];
  // the chunk's first column in segment coordinates: one modulo a row
  // chunk, the same in every thread
  long long i = (long long)start + chunk0;
  if (wrap > 0) {
    i %= wrap;
    if (i < 0) i += wrap;
  }
  if (!live) return;
  const long long idx = (long long)start + col0;   // unwrapped
  i += threadIdx.x * VEC;
  if (wrap > 0 && i >= wrap) i -= wrap;            // one wrap point
  uint4 v;
  if (col0 >= cap || seglen <= 0 || (wrap <= 0 && idx >= seglen)) {
    v = make_uint4(NCODE4, NCODE4, NCODE4, NCODE4);
  } else if (col0 + VEC <= cap && i >= 0 && i + VEC <= seglen &&
             (wrap <= 0 || i + VEC <= wrap) &&
             ((base + i) & ~15LL) + 2 * VEC <= n) {
    const long long p = base + i;
    const uint4* w = reinterpret_cast<const uint4*>(store + (p & ~15LL));
    v = window16(__ldg(w), __ldg(w + 1), (int)(p & 15));
  } else {
    uint32_t x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 4 * k + j;
        const int8_t c = pick(store, base, (long long)start + col, cap,
                              seglen, wrap, col);
        x[k] |= (uint32_t)(uint8_t)c << (8 * j);
      }
    }
    v = make_uint4(x[0], x[1], x[2], x[3]);
  }
  reinterpret_cast<uint4*>(row)[col0 / VEC] = v;
}

}  // namespace

// Ba rows of side a (row length La) and Bb of side b (Lb); La and Lb
// multiples of 16, the stores and outputs 16-byte aligned.
extern "C" int gather_pair_launch(const void* store_a, long long n_a,
                                  const void* store_b, long long n_b,
                                  const void* desc, int Ba, int Bb, int La,
                                  int Lb, void* out_a, void* out_b,
                                  void* stream) {
  if (La < 0 || Lb < 0 || La % VEC || Lb % VEC || Ba < 0 || Bb < 0 ||
      ((uintptr_t)store_a | (uintptr_t)store_b | (uintptr_t)out_a |
       (uintptr_t)out_b) % VEC)
    return (int)cudaErrorInvalidValue;
  const int Lmax = max(Ba ? La : 0, Bb ? Lb : 0);
  const int R = Ba + Bb;
  if (R == 0 || Lmax == 0) return (int)cudaSuccess;
  const dim3 grid(R, (Lmax + CHUNK - 1) / CHUNK);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gather_pair_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(store_a), n_a,
      static_cast<const int8_t*>(store_b), n_b,
      static_cast<const int32_t*>(desc), Ba, R, La, Lb,
      static_cast<int8_t*>(out_a), static_cast<int8_t*>(out_b));
  return (int)cudaGetLastError();
}
