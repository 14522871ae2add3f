// P4: the primitives of a packed-character word stream on (8, C) int32
// slabs: a per-element variable shift, a per-column row roll in a loop
// carry, the divide-by-10 multiply, and the timing loop of the two-sided
// stream update.
//
// Replaces tests/tools/probe_wordstream.py:var_shift, :roll_in_carry,
// :div10_magic and :stream_timing (Pallas, TPU) and is held against
// minialign_tpu_torch/probes/wordstream.py's *_plain twins, bit for bit.
//
// var_shift, div10_magic: one thread per element. Signed int32 overflow
// is undefined in C++, so the multiply is done in uint32 and read back as
// int32 (the wrap the TPU's int32 multiply gives); >> is arithmetic.
//
// roll_in_carry, stream_timing: one thread per column; the column's 8
// words sit in registers, and the row roll (row r <- row r + 1 mod 8,
// pltpu.roll(slab, 7, 0)) is a register rotation under the column's
// predicate. What bounds stream_timing: the per-step dependent chain
// (shift, mask, add, compare, rotate) of one thread; the 128 columns
// are one block, one warp per scheduler of one SM.

#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int R = 8;  // slab rows
constexpr int THREADS = 128;

// x >> s with s taken as unsigned and clamped to 31 (sign fill past the
// width, as XLA's shift_right_arithmetic)
__device__ __forceinline__ int32_t sra(int32_t x, int32_t s) {
  return x >> ((uint32_t)s > 31u ? 31 : s);
}

__device__ __forceinline__ void rotate_if(int32_t (&s)[R], bool p) {
  const int32_t s0 = s[0];
#pragma unroll
  for (int r = 0; r < R - 1; ++r) s[r] = p ? s[r + 1] : s[r];
  s[R - 1] = p ? s0 : s[R - 1];
}

__global__ void __launch_bounds__(THREADS)
var_shift_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ s,
                 int n, int32_t* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = sra(w[i], (int32_t)(3u * (uint32_t)s[i])) & 7;
}

__global__ void __launch_bounds__(THREADS)
div10_kernel(const int32_t* __restrict__ x, int n,
             int32_t* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = (int32_t)((uint32_t)(x[i] >> 1) * 52429u) >> 18;
}

__global__ void __launch_bounds__(THREADS)
roll_in_carry_kernel(const int32_t* __restrict__ w, int C, int rounds,
                     int32_t* __restrict__ out) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= C) return;
  int32_t s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = w[r * C + col];
  int32_t sh = 0;
  for (int i = 0; i < rounds; ++i) {
    const bool wrap = sh >= 30;
    rotate_if(s, wrap);
    sh = wrap ? 0 : sh + 3;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    out[r * C + col] = (int32_t)((uint32_t)s[r] + (uint32_t)sh);
}

__global__ void __launch_bounds__(THREADS)
stream_kernel(const int32_t* __restrict__ wa, const int32_t* __restrict__ wb,
              const int32_t* __restrict__ d, int C, int steps,
              int32_t* __restrict__ out) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= C) return;
  int32_t sa[R], sb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sa[r] = wa[r * C + col];
    sb[r] = wb[r * C + col];
  }
  const int dc = d[col];
  int32_t sha = 0, shb = 0;
  uint32_t acc = 0;
  int im7 = 0;  // i % 7
  for (int i = 0; i < steps; ++i) {
    const int32_t cura = sra(sa[0], sha) & 7;
    const int32_t curb = sra(sb[0], shb) & 7;
    const bool down = dc > im7;
    im7 = im7 == 6 ? 0 : im7 + 1;
    sha += down ? 0 : 3;
    shb += down ? 3 : 0;
    const bool pa = sha >= 30, pb = shb >= 30;
    rotate_if(sa, pa);
    rotate_if(sb, pb);
    sha = pa ? 0 : sha;
    shb = pb ? 0 : shb;
    acc += (uint32_t)cura + (uint32_t)curb;
  }
  out[col] = (int32_t)(acc + (uint32_t)sa[0] + (uint32_t)sb[0]);
}

inline int grid(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// w, s, out: n int32 each.
extern "C" int p4_var_shift_launch(const void* w, const void* s, int n,
                                   void* out, int device, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  var_shift_kernel<<<grid(n), THREADS, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(s), n,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int p4_div10_launch(const void* x, int n, void* out,
                               int device, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  div10_kernel<<<grid(n), THREADS, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(x), n, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// w, out: (8, C) int32.
extern "C" int p4_roll_in_carry_launch(const void* w, int C, int rounds,
                                       void* out, int device,
                                       void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  roll_in_carry_kernel<<<grid(C), THREADS, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(w), C, rounds, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// wa, wb: (8, C) int32; d: (C,) int32; out: (C,) int32.
extern "C" int p4_stream_launch(const void* wa, const void* wb,
                                const void* d, int C, int steps, void* out,
                                int device, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  stream_kernel<<<grid(C), THREADS, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(wa), static_cast<const int32_t*>(wb),
      static_cast<const int32_t*>(d), C, steps, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
