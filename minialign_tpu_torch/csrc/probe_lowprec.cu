// P2: low-precision add / max / compare / select, the 8-round carries,
// and the band-step timer, in int16 / int8 / bf16 / f32 / int32.
//
// Replaces tests/tools/probe_lowprec.py:elementwise, :in_carry,
// :roll_concat and :step_timer (Pallas, TPU) and is held against
// minialign_tpu_torch/probes/lowprec.py's *_plain twins, bit for bit.
//
// elementwise / in_carry: one thread per element
// (probe_common.cuh:binop_kernel), the result as float32.
//
// roll_concat / step_timer: the fill's own layout (fill.cu): one warp
// per column of W = 64 rows, rows t and t + 32 on thread t, all state in
// registers for the whole loop; the row roll concatenate([a[1:], 0]) is
// fill.cu's roll_up (two __shfl_down_sync and one __shfl_sync), taken
// only when the column's direction d[col] > i % 7 holds, which is
// warp-uniform, as the fill's down/up branch is. A step_timer step is,
// for each of the 4 arrays a (old values throughout):
//   a <- max((d ? roll_up(a) : a) + 1, arrs[0])
// with max(x + 1, y) as the DPX __viaddmax_s32 for int32.
// What bounds it: the dependent chain shuffle -> select -> add-max per
// step with one warp per column. B = 128 columns give 32 blocks, one
// warp per scheduler on 32 SMs: latency. B = 1024 give 256 blocks, about
// two warps per scheduler on every SM: issue. The two widths say how
// much of the chain more columns per SM hide (the fill's question).

#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int WARPS = 4;  // columns per block
constexpr int N_ARR = 4;  // probe_lowprec.step_timer's n_arr

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
roll_concat_kernel(const T* __restrict__ x, const T* __restrict__ y, int B,
                   int rounds, float* __restrict__ out) {
  const int t = threadIdx.x & 31;
  const int col = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (col >= B) return;  // warp-uniform
  T lo = x[t * B + col], hi = x[(t + 32) * B + col];
  const bool d = gt(y[col], y[B + col]);  // y[0:1] > y[1:2]
  const T one = from_int<T>(1);
  for (int r = 0; r < rounds; ++r) {
    if (d) roll_up(lo, hi, t);
    lo = add(lo, one);
    hi = add(hi, one);
  }
  out[t * B + col] = to_f32(lo);
  out[(t + 32) * B + col] = to_f32(hi);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
step_timer_kernel(const T* __restrict__ x, const int32_t* __restrict__ dd,
                  int B, int n_steps, float* __restrict__ out) {
  const int t = threadIdx.x & 31;
  const int col = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (col >= B) return;  // warp-uniform
  const T x0 = x[t * B + col], x1 = x[(t + 32) * B + col];
  T lo[N_ARR], hi[N_ARR];
#pragma unroll
  for (int k = 0; k < N_ARR; ++k) {
    lo[k] = add(x0, from_int<T>(k));
    hi[k] = add(x1, from_int<T>(k));
  }
  const int dcol = dd[col];
  const T one = from_int<T>(1);
  int im7 = 0;  // i % 7
  for (int i = 0; i < n_steps; ++i) {
    const bool d = dcol > im7;
    im7 = im7 == 6 ? 0 : im7 + 1;
    const T f0 = lo[0], f1 = hi[0];
#pragma unroll
    for (int k = 0; k < N_ARR; ++k) {
      if (d) roll_up(lo[k], hi[k], t);
      lo[k] = addmax(lo[k], one, f0);
      hi[k] = addmax(hi[k], one, f1);
    }
  }
  T a = lo[0], b = hi[0];
#pragma unroll
  for (int k = 1; k < N_ARR; ++k) {
    a = vmax(a, lo[k]);
    b = vmax(b, hi[k]);
  }
  out[t * B + col] = to_f32(a);
  out[(t + 32) * B + col] = to_f32(b);
}

}  // namespace

extern "C" int p2_elementwise_launch(const void* x, const void* y, int n,
                                     int dtype, int op, int rounds,
                                     void* out, void* stream) {
  return binop_launch<float>(x, y, n, dtype, op, rounds, out, stream);
}

// x, y: (64, B) of the dtype; out (64, B) float32.
extern "C" int p2_roll_concat_launch(const void* x, const void* y, int B,
                                     int dtype, int rounds, void* out,
                                     void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    roll_concat_kernel<T><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                            as_stream(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), B, rounds,
        static_cast<float*>(out));
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x: (64, B) of the dtype; dd: (B,) int32; out (64, B) float32.
extern "C" int p2_step_timer_launch(const void* x, const void* dd, int B,
                                    int dtype, int n_steps, void* out,
                                    void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    step_timer_kernel<T><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                           as_stream(stream)>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(dd), B,
        n_steps, static_cast<float*>(out));
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
