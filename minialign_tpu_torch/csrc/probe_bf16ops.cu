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
// timing: the fill's layout (fill.cu), one warp per column of W = 64
// rows, rows t and t + 32 on thread t, the 6 arrays in registers for the
// whole loop. A step is, for each array a (old values throughout):
//   a <- max(max(a + 1, arrs[5]) - 1, arrs[0] - 1)
// with max(a + 1, b) as the DPX __viaddmax_s32 for int32. There is no
// roll, so a step is 12 independent chains of three dependent ops per
// thread; at B = 128 (32 blocks, one warp per scheduler on 32 SMs) what
// bounds it is one warp's issue of those ~36 ops a step.

#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int WARPS = 4;  // columns per block
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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
timing_kernel(const T* __restrict__ x, int B, int steps,
              float* __restrict__ out) {
  const int t = threadIdx.x & 31;
  const int col = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (col >= B) return;
  const T x0 = x[t * B + col], x1 = x[(t + 32) * B + col];
  T lo[N_ARR], hi[N_ARR];
#pragma unroll
  for (int k = 0; k < N_ARR; ++k) {
    lo[k] = add(x0, from_int<T>(k % 3));
    hi[k] = add(x1, from_int<T>(k % 3));
  }
  const T one = from_int<T>(1);
  for (int i = 0; i < steps; ++i) {
    const T p0 = lo[N_ARR - 1], p1 = hi[N_ARR - 1];
    const T f0 = sub(lo[0], one), f1 = sub(hi[0], one);
#pragma unroll
    for (int k = 0; k < N_ARR; ++k) {
      lo[k] = vmax(sub(addmax(lo[k], one, p0), one), f0);
      hi[k] = vmax(sub(addmax(hi[k], one, p1), one), f1);
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

// x: (64, B) of the dtype; out (64, B) float32.
extern "C" int p3_timing_launch(const void* x, int B, int dtype, int steps,
                                void* out, int device, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    timing_kernel<T><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                       as_stream(stream)>>>(
        static_cast<const T*>(x), B, steps, static_cast<float*>(out));
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
