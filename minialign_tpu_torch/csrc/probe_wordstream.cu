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
// roll_in_carry, stream_timing: the row roll (row r <- row r + 1 mod 8,
// pltpu.roll(slab, 7, 0)) is a row pointer, not a move of the 8 words.
// roll_in_carry carries the pointer and the shift through its rounds, one
// thread a column, and reads each output row's word at the end.
// stream_timing is a true recurrence of C columns, two streams each, far
// from the card's operation rate at C = 128 (8 warps): what bounds it is
// one stream's step on one warp. So a stream gets a lane of its own (lane
// 2c stream a, lane 2c + 1 stream b of column c), with its own half of
// the sum, joined by one shuffle after the loop; blocks of one warp (16
// columns), at most one warp a scheduler. A step of a lane is the read
// (cur >> sh) & 7, the sum's add, the shift's add, the wrap compare and
// two selects, about 8 instructions with the pass's end, issued at the
// integer pipe's half rate; the chain from one step to the next (the
// shift's add or compare, then its select) is shorter. The current word
// sits in a register, the slab in shared memory; the loop runs 7 steps a
// pass, the pass's 7 advances (3 or 0: d[col] > i % 7 moves stream b,
// else stream a) computed once before the loop, then the steps % 7 left. A pass holds at most one wrap (a wrap
// needs 10 advances of 3 to reach 30 from 0, a pass has 7), seen at its
// end from the shift, and a wrap there moves the pointer and takes the
// word two rows on from shared memory: that load has a pass or more
// before its word is read, and the next word is always in a register.

#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int R = 8;  // slab rows
constexpr int THREADS = 128;      // var_shift, div10: a value a thread
constexpr int LOOP_THREADS = 32;  // roll_in_carry, stream: one warp a block

// x >> s with s taken as unsigned and clamped to 31 (sign fill past the
// width, as XLA's shift_right_arithmetic): var_shift's amounts come from
// its input
__device__ __forceinline__ int32_t sra(int32_t x, int32_t s) {
  return x >> ((uint32_t)s > 31u ? 31 : s);
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

__global__ void __launch_bounds__(LOOP_THREADS)
roll_in_carry_kernel(const int32_t* __restrict__ w, int C, int rounds,
                     int32_t* __restrict__ out) {
  const int col = blockIdx.x * LOOP_THREADS + threadIdx.x;
  if (col >= C) return;
  int r = 0, sh = 0;  // rows rolled, shift
  for (int i = 0; i < rounds; ++i) {
    const bool wrap = sh >= 30;
    r += wrap;
    sh = wrap ? 0 : sh + 3;
  }
#pragma unroll
  for (int row = 0; row < R; ++row)
    out[row * C + col] =
        (int32_t)((uint32_t)w[((row + r) & (R - 1)) * C + col] + (uint32_t)sh);
}

// One step of one stream. The shift sh is a multiple of 3 in [0, 27] at
// every step: it starts at 0, grows by 0 or 3, and is reset to 0 when it
// reaches 30. So cur >> sh needs no clamp, and (cur >> sh) & 7 reads bits
// sh..sh + 2 <= 29. The wrap compares the old shift with 30 - inc (sh + inc
// >= 30), beside the add, so that the chain a step is add or compare, then
// the select.
__device__ __forceinline__ void stream_step(uint32_t& acc, int& sh,
                                            int32_t& cur, int32_t nxt,
                                            int inc, int thr) {
  acc += (uint32_t)((cur >> sh) & 7);
  const bool wrap = sh >= thr;
  cur = wrap ? nxt : cur;
  sh = wrap ? 0 : sh + inc;
}

__global__ void __launch_bounds__(LOOP_THREADS)
stream_kernel(const int32_t* __restrict__ wa, const int32_t* __restrict__ wb,
              const int32_t* __restrict__ d, int C, int steps,
              int32_t* __restrict__ out) {
  __shared__ int32_t slab[R][LOOP_THREADS];  // each lane's own column
  const int t = threadIdx.x;
  const int side = t & 1;  // 0: stream a, 1: stream b
  const int col = (blockIdx.x * LOOP_THREADS + t) >> 1;
  const bool live = col < C;  // dead lanes run on zeros, store nothing
  const int32_t* w = side ? wb : wa;
#pragma unroll
  for (int r = 0; r < R; ++r) slab[r][t] = live ? w[r * C + col] : 0;
  const int dc = live ? d[col] : 0;
  int inc[7], thr[7], adv = 0;  // step i % 7: advance, wrap threshold
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const bool down = dc > j;
    inc[j] = down == (side == 1) ? 3 : 0;
    thr[j] = 30 - inc[j];
    adv += inc[j];
  }
  // Opaque from here on, so that the loop reads the advances and
  // thresholds from registers. Without it the compiler gave every step's
  // wrap compare one predicate register, one step after another: 10.2
  // against 7.9 ns/step at C = 128 (PERF.md).
#pragma unroll
  for (int j = 0; j < 7; ++j) asm volatile("" : "+r"(inc[j]), "+r"(thr[j]));
  uint32_t acc = 0;
  int sh = 0, r = 0;  // cur = slab[r], nxt = slab[r + 1], nxt2 = slab[r + 2]
  int32_t cur = slab[0][t], nxt = slab[1][t], nxt2 = slab[2][t];
  const int passes = steps > 0 ? steps / 7 : 0;
  for (int p = 0; p < passes; ++p) {
    const int sh0 = sh;
#pragma unroll
    for (int j = 0; j < 7; ++j)
      stream_step(acc, sh, cur, nxt, inc[j], thr[j]);
    if (sh != sh0 + adv) {  // wrapped in this pass (cur = nxt there)
      r = (r + 1) & (R - 1);
      nxt = nxt2;
      nxt2 = slab[(r + 2) & (R - 1)][t];
    }
  }
  const int rest = steps - 7 * passes;
#pragma unroll
  for (int j = 0; j < 6; ++j)
    if (j < rest) stream_step(acc, sh, cur, nxt, inc[j], thr[j]);
  uint32_t v = acc + (uint32_t)cur;
  v += __shfl_xor_sync(FULL, v, 1);
  if (side == 0 && live) out[col] = (int32_t)v;
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
  roll_in_carry_kernel<<<(C + LOOP_THREADS - 1) / LOOP_THREADS,
                         LOOP_THREADS, 0, as_stream(stream)>>>(
      static_cast<const int32_t*>(w), C, rounds, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// wa, wb: (8, C) int32; d: (C,) int32; out: (C,) int32.
extern "C" int p4_stream_launch(const void* wa, const void* wb,
                                const void* d, int C, int steps, void* out,
                                int device, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  stream_kernel<<<(2 * C + LOOP_THREADS - 1) / LOOP_THREADS, LOOP_THREADS, 0,
                  as_stream(stream)>>>(
      static_cast<const int32_t*>(wa), static_cast<const int32_t*>(wb),
      static_cast<const int32_t*>(d), C, steps, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
