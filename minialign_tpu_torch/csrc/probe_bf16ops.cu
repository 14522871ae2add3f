// P3: the bf16 building blocks of a difference-recurrence step, and the
// timing loop of its op mix in int32 / f32 / bf16.
//
// Replaces tests/tools/probe_bf16ops.py:run2 (the 10 lambdas of its
// main, one op code each: probes/bf16ops.py:OPS) and :timing (Pallas,
// TPU), and is held against minialign_tpu_torch/probes/bf16ops.py's
// run2_plain and timing_plain, bit for bit.
//
// run2: one thread per element of the (R, C) arrays; concat-roll reads
// row r + 1 (0 past the last row), the broadcast-row multiply reads
// b[0, col]. Launch-bound at the probe's shape.
//
// timing: a step is, for each of the 6 arrays a (old values throughout):
//   a <- max(max(a + 1, arrs[5]) - 1, arrs[0] - 1).
// Rows never mix, so every (row, column) element is a chain of its own:
// 6 values whose step is 6 add-max-sub-max groups and one sub, with
// three dependent ops from a step to the next. What bounds it is one
// warp's issue of those ops a step: the whole (64, B) array is only
// 64 B values, too few warps to fill the card, so the design spreads
// them to at most one warp a scheduler and gives each as few
// instructions a step as the types allow.
//   - int32, float32: one element a thread, 64 threads a block (B blocks:
//     128 at the tools' B, one an SM). int32 issues each max(x + b, c) as
//     one DPX VIADDMNMX (__viaddmax_s32): the add and the first max, then
//     the sub (+ -1) and the second max, two instructions an array a step;
//     float32 issues FADD, FMNMX, FADD, FMNMX.
//   - 16- and 8-bit types: rows t and t + 32 of a column in one word on
//     thread t (probe_common.cuh:Pair), one warp a column, each op on
//     both rows at once: bf16 __hadd2 / __hmax2, int16 the DPX
//     __viaddmax_s16x2 (add and max in one instruction, wrapping per
//     lane), int8 / uint8 the byte ops.
// The sub is an add of -1 in every type: the same result, bit for bit
// (IEEE defines a - b as a + (-b); the integers wrap alike).

#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int W = 64;     // rows of the timing loop's arrays
constexpr int N_ARR = 6;  // the tool's main: timing(dt, 6, steps)

template <typename T>
__device__ __forceinline__ float run2_op(int op, const T* __restrict__ x,
                                         const T* __restrict__ y, int R,
                                         int C, int i) {
  const T a = x[i], b = y[i];
  const T zero = from_int<T>(0), one = from_int<T>(1);
  switch (op) {
    case 0:  // a * b
      return to_f32(mul(a, b));
    case 1:  // a - b
      return to_f32(sub(a, b));
    case 2:  // concatenate([a[1:], 0]) + b
      return to_f32(add(i / C + 1 < R ? x[i + C] : zero, b));
    case 3:  // max(1 - (max(a, b) - b), 0)
      return to_f32(vmax(sub(one, sub(vmax(a, b), b)), zero));
    case 4: {  // a + max(1 - (max(a, b) - b), 0) * (b - a)
      const T m = vmax(sub(one, sub(vmax(a, b), b)), zero);
      return to_f32(add(a, mul(m, sub(b, a))));
    }
    case 5:  // min(a, b)
      return to_f32(vmin(a, b));
    case 6:  // a * b[0:1]
      return to_f32(mul(a, y[i % C]));
    case 7:  // (a + b).astype(int32).astype(float32)
      return (float)to_i32(add(a, b));
    case 8:  // (a + b).astype(bfloat16)
      return __bfloat162float(__float2bfloat16_rn(to_f32(add(a, b))));
    default:  // (a.astype(int32) + b.astype(int32)).astype(int16)
      return (float)(int16_t)((uint32_t)to_i32(a) + (uint32_t)to_i32(b));
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
run2_kernel(const T* __restrict__ x, const T* __restrict__ y, int R, int C,
            int op, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * C) return;
  out[i] = run2_op(op, x, y, R, C, i);
}

// One (row, column) element a thread, the (64, B) array flat.
template <typename T>
__global__ void __launch_bounds__(W)
timing_kernel(const T* __restrict__ x, int n, int steps,
              float* __restrict__ out) {
  const int i = blockIdx.x * W + threadIdx.x;
  if (i >= n) return;
  const T x0 = x[i];
  T a[N_ARR];
#pragma unroll
  for (int k = 0; k < N_ARR; ++k) a[k] = add(x0, from_int<T>(k % 3));
  const T one = from_int<T>(1), minus_one = from_int<T>(-1);
  for (int s = 0; s < steps; ++s) {
    const T p = a[N_ARR - 1], f = add(a[0], minus_one);
#pragma unroll
    for (int k = 0; k < N_ARR; ++k)
      a[k] = addmax(addmax(a[k], one, p), minus_one, f);
  }
  T m = a[0];
#pragma unroll
  for (int k = 1; k < N_ARR; ++k) m = vmax(m, a[k]);
  out[i] = to_f32(m);
}

// Rows t and t + 32 of column blockIdx.x in one word on thread t.
template <typename T>
__global__ void __launch_bounds__(32)
timing_pair_kernel(const T* __restrict__ x, int B, int steps,
                   float* __restrict__ out) {
  using L = Lanes<T>;
  const int t = threadIdx.x;
  const int col = blockIdx.x;
  const uint32_t x2 = Pair<T>::pack(x[t * B + col], x[(t + 32) * B + col]);
  uint32_t a[N_ARR];
#pragma unroll
  for (int k = 0; k < N_ARR; ++k) a[k] = L::add(x2, Pair<T>::splat(k % 3));
  const uint32_t one = Pair<T>::splat(1), minus_one = Pair<T>::splat(-1);
  for (int s = 0; s < steps; ++s) {
    const uint32_t p = a[N_ARR - 1], f = L::add(a[0], minus_one);
#pragma unroll
    for (int k = 0; k < N_ARR; ++k)
      a[k] = addmax_pair<T>(addmax_pair<T>(a[k], one, p), minus_one, f);
  }
  uint32_t m = a[0];
#pragma unroll
  for (int k = 1; k < N_ARR; ++k) m = L::max(m, a[k]);
  out[t * B + col] = L::f32(m, 0);
  out[(t + 32) * B + col] = L::f32(m, Pair<T>::HI);
}

}  // namespace

// x, y: (R, C) of the dtype; out (R, C) float32.
extern "C" int p3_run2_launch(const void* x, const void* y, int R, int C,
                              int dtype, int op, void* out, int device,
                              void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaSuccess;
  if (op < 0 || op > 9) return (int)cudaErrorInvalidValue;
  const DeviceGuard on(device);
  const int n = R * C;
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    run2_kernel<T><<<(n + 255) / 256, 256, 0, as_stream(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), R, C, op,
        static_cast<float*>(out));
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x: (64, B) of the dtype; out (64, B) float32. 32-bit types one element
// a thread, the others in packed pairs.
extern "C" int p3_timing_launch(const void* x, int B, int dtype, int steps,
                                void* out, int device, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const T* xt = static_cast<const T*>(x);
    float* o = static_cast<float*>(out);
    if constexpr (sizeof(T) == 4)
      timing_kernel<T><<<B, W, 0, as_stream(stream)>>>(xt, W * B, steps, o);
    else
      timing_pair_kernel<T><<<B, 32, 0, as_stream(stream)>>>(xt, B, steps,
                                                             o);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
