// Element types and per-op arithmetic shared by the step-mix probes
// (probe_*.cu). Every op rounds or wraps to its type after the op, as
// JAX types it and as torch computes it:
//   - int8 / uint8 / int16 / int32: computed in 32 bits, unsigned where a
//     signed result could overflow, then cut to the type's width
//     (two's complement wrap); compares on uint8 are unsigned, >> on
//     signed types is arithmetic;
//   - bfloat16: the sm_90 bf16 instructions (__hadd, __hmax, ...), each
//     rounded to nearest even, i.e. the exact result rounded once;
//   - float32: IEEE single.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace probe {

// dtype codes; minialign_tpu_torch/probes/_common.py:DTYPES mirrors them
enum Dtype { I8 = 0, U8 = 1, I16 = 2, I32 = 3, BF16 = 4, F32 = 5 };

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
constexpr bool is_int = std::is_integral<T>::value;

template <typename T>
__device__ __forceinline__ T from_int(int v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn((float)v);
  else
    return (T)v;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(v);
  else
    return (float)v;
}

// float -> int32 truncates toward zero (values in range)
template <typename T>
__device__ __forceinline__ int to_i32(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return (int)__bfloat162float(v);
  else
    return (int)v;
}

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __hadd(a, b);
  else if constexpr (is_int<T>)
    return (T)((uint32_t)a + (uint32_t)b);
  else
    return a + b;
}

template <typename T>
__device__ __forceinline__ T sub(T a, T b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __hsub(a, b);
  else if constexpr (is_int<T>)
    return (T)((uint32_t)a - (uint32_t)b);
  else
    return a - b;
}

template <typename T>
__device__ __forceinline__ T mul(T a, T b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __hmul(a, b);
  else if constexpr (is_int<T>)
    return (T)((uint32_t)a * (uint32_t)b);
  else
    return a * b;
}

template <typename T>
__device__ __forceinline__ bool gt(T a, T b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __hgt(a, b);
  else
    return a > b;
}

template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __hmax(a, b);
  else if constexpr (std::is_same<T, float>::value)
    return fmaxf(a, b);
  else
    return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __hmin(a, b);
  else if constexpr (std::is_same<T, float>::value)
    return fminf(a, b);
  else
    return a < b ? a : b;
}

// max(a + b, c): for int32 the Hopper DPX instruction (one VIADDMNMX)
template <typename T>
__device__ __forceinline__ T addmax(T a, T b, T c) {
  if constexpr (std::is_same<T, int32_t>::value)
    return __viaddmax_s32(a, b, c);
  else
    return vmax(add(a, b), c);
}

// the value's bits in a 32-bit register, for __shfl_*_sync
template <typename T>
__device__ __forceinline__ uint32_t to_bits(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat16_as_ushort(v);
  else if constexpr (std::is_same<T, float>::value)
    return __float_as_uint(v);
  else
    return (uint32_t)v;
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __ushort_as_bfloat16((unsigned short)v);
  else if constexpr (std::is_same<T, float>::value)
    return __uint_as_float(v);
  else
    return (T)v;
}

// W = 64 rows of one column in one warp, rows t and t + 32 on thread t.
// roll_up: out[r] = x[r + 1], 0 at r = 63 (fill.cu's roll_up with fill 0;
// the Pallas probes' concatenate([c[1:], 0])).
template <typename T>
__device__ __forceinline__ void roll_up(T& lo, T& hi, int t) {
  const uint32_t v0 = __shfl_down_sync(FULL, to_bits(lo), 1);
  const uint32_t v1 = __shfl_down_sync(FULL, to_bits(hi), 1);
  const uint32_t w = __shfl_sync(FULL, to_bits(hi), 0);
  lo = from_bits<T>(t == 31 ? w : v0);
  hi = t == 31 ? from_int<T>(0) : from_bits<T>(v1);
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the dtype code (f a generic lambda that reads T as
// typename decltype(tag)::type); false for an unknown code.
template <typename F>
bool dispatch(int dtype, F&& f) {
  switch (dtype) {
    case I8: f(Tag<int8_t>{}); return true;
    case U8: f(Tag<uint8_t>{}); return true;
    case I16: f(Tag<int16_t>{}); return true;
    case I32: f(Tag<int32_t>{}); return true;
    case BF16: f(Tag<__nv_bfloat16>{}); return true;
    case F32: f(Tag<float>{}); return true;
  }
  return false;
}

inline cudaStream_t as_stream(void* s) {
  return static_cast<cudaStream_t>(s);
}

// The binary ops of P1 and P2 (probes/_common.py:BINOPS): add, maximum,
// compare-gt, select = where(a > b, a, b). compare-gt gives 0 / 1.
template <typename T>
__device__ __forceinline__ T binop(int op, T a, T b) {
  switch (op) {
    case 0: return add(a, b);
    case 1: return vmax(a, b);
    case 2: return from_int<T>(gt(a, b) ? 1 : 0);
    default: return gt(a, b) ? a : b;
  }
}

template <typename O, typename T>
__device__ __forceinline__ O convert(T v) {
  if constexpr (std::is_same<O, float>::value)
    return to_f32(v);
  else
    return (O)to_i32(v);
}

// One thread per element: out = op(x, y) (rounds = 0), or c <- op(c, y)
// cut to T, `rounds` times from c = x (the probes' fori_loop carry);
// then converted to O (int32 or float32).
template <typename T, typename O>
__global__ void __launch_bounds__(256)
binop_kernel(const T* __restrict__ x, const T* __restrict__ y, int n,
             int op, int rounds, O* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T b = y[i];
  T c = rounds == 0 ? binop(op, x[i], b) : x[i];
  for (int r = 0; r < rounds; ++r) c = binop(op, c, b);
  out[i] = convert<O>(c);
}

template <typename O>
int binop_launch(const void* x, const void* y, int n, int dtype, int op,
                 int rounds, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (op < 0 || op > 3 || rounds < 0) return (int)cudaErrorInvalidValue;
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    binop_kernel<T, O><<<(n + 255) / 256, 256, 0, as_stream(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), n, op, rounds,
        static_cast<O*>(out));
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace probe
