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
#include <cstring>
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

// Makes `device` current for a launch when it is not already, and gives
// the caller's device back after (the wrappers pass the inputs' device
// index, so Python sets no device a call).
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    int cur;
    if (cudaGetDevice(&cur) == cudaSuccess && cur != device &&
        cudaSetDevice(device) == cudaSuccess)
      prev = cur;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// ---- P1's and P2's elementwise kernel, on packed lanes

// The binary ops of P1 and P2 (probes/_common.py:BINOPS): add, maximum,
// compare-gt (0 / 1 in the inputs' type), select = where(a > b, a, b).
enum Op { ADD = 0, MAX = 1, GT = 2, SEL = 3 };

// One 32-bit word of T's lanes: 4 int8 / uint8, 2 int16 / bf16, or one
// int32 / float32, lane k in bits 32 / N * k up. Each op acts on every
// lane at once and wraps or rounds per lane as JAX types it: the SIMD
// video intrinsics for the integers (__vadd4 wraps per byte; __vcmpgt*
// give all ones in a lane where a > b), bf16x2 arithmetic rounded per
// lane as __hadd rounds one value. f32 / i32 read lane k as float32 /
// int32 (float -> int truncates toward zero).
template <typename T>
struct Lanes;

template <>
struct Lanes<int8_t> {
  static constexpr int N = 4;
  static constexpr uint32_t ONE = 0x01010101u;
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return __vadd4(a, b);
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return __vmaxs4(a, b);
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return __vcmpgts4(a, b);
  }
  static __device__ __forceinline__ int i32(uint32_t w, int k) {
    return (int32_t)(w << (24 - 8 * k)) >> 24;
  }
  static __device__ __forceinline__ float f32(uint32_t w, int k) {
    return (float)i32(w, k);
  }
};

template <>
struct Lanes<uint8_t> {
  static constexpr int N = 4;
  static constexpr uint32_t ONE = 0x01010101u;
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return __vadd4(a, b);
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return __vmaxu4(a, b);
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return __vcmpgtu4(a, b);
  }
  static __device__ __forceinline__ int i32(uint32_t w, int k) {
    return (w >> (8 * k)) & 0xff;
  }
  static __device__ __forceinline__ float f32(uint32_t w, int k) {
    return (float)i32(w, k);
  }
};

template <>
struct Lanes<int16_t> {
  static constexpr int N = 2;
  static constexpr uint32_t ONE = 0x00010001u;
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return __vadd2(a, b);
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return __vmaxs2(a, b);
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return __vcmpgts2(a, b);
  }
  static __device__ __forceinline__ int i32(uint32_t w, int k) {
    return (int32_t)(w << (16 - 16 * k)) >> 16;
  }
  static __device__ __forceinline__ float f32(uint32_t w, int k) {
    return (float)i32(w, k);
  }
};

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t w) {
  __nv_bfloat162 v;
  memcpy(&v, &w, 4);
  return v;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t w;
  memcpy(&w, &v, 4);
  return w;
}

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 2;
  static constexpr uint32_t ONE = 0x3f803f80u;  // 1.0 in each lane
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return as_u32(__hadd2(as_bf16x2(a), as_bf16x2(b)));
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return as_u32(__hmax2(as_bf16x2(a), as_bf16x2(b)));
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return __hgt2_mask(as_bf16x2(a), as_bf16x2(b));
  }
  static __device__ __forceinline__ float f32(uint32_t w, int k) {
    return __uint_as_float(k ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ int i32(uint32_t w, int k) {
    return (int)f32(w, k);
  }
};

template <>
struct Lanes<int32_t> {
  static constexpr int N = 1;
  static constexpr uint32_t ONE = 1u;
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return a + b;
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return (uint32_t)::max((int32_t)a, (int32_t)b);
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return (int32_t)a > (int32_t)b ? FULL : 0u;
  }
  static __device__ __forceinline__ int i32(uint32_t w, int) {
    return (int32_t)w;
  }
  static __device__ __forceinline__ float f32(uint32_t w, int) {
    return (float)(int32_t)w;
  }
};

template <>
struct Lanes<float> {
  static constexpr int N = 1;
  static constexpr uint32_t ONE = 0x3f800000u;  // 1.0f
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }
  static __device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t b) {
    return __uint_as_float(a) > __uint_as_float(b) ? FULL : 0u;
  }
  static __device__ __forceinline__ int i32(uint32_t w, int) {
    return (int)__uint_as_float(w);
  }
  static __device__ __forceinline__ float f32(uint32_t w, int) {
    return __uint_as_float(w);
  }
};

// Rows t and t + 32 of one column in one 32-bit word on thread t: row t
// in the low half, row t + 32 in the high half (the loop kernels of P2
// and P3). A 16-bit type fills its half (Lanes<T> lanes 0 and 1); int8
// and uint8 sit in the low byte of each half (Lanes lanes 0 and 2), the
// high bytes staying 0 under the byte ops.
template <typename T>
struct Pair {
  static constexpr int HI = Lanes<T>::N / 2;  // Lanes' lane of row t + 32
  static constexpr uint32_t MASK = sizeof(T) == 1 ? 0xffu : 0xffffu;
  static __device__ __forceinline__ uint32_t pack(T lo, T hi) {
    return (to_bits(lo) & MASK) | (to_bits(hi) & MASK) << 16;
  }
  static __device__ __forceinline__ uint32_t splat(int v) {
    return pack(from_int<T>(v), from_int<T>(v));
  }
};

// max(a + b, c) on both lanes, the add wrapping per lane: int16 by the
// DPX __viaddmax_s16x2, bf16 by __hadd2 then __hmax2, int8 / uint8 by
// the byte ops.
template <typename T>
__device__ __forceinline__ uint32_t addmax_pair(uint32_t a, uint32_t b,
                                                uint32_t c) {
  if constexpr (std::is_same<T, int16_t>::value)
    return __viaddmax_s16x2(a, b, c);
  else
    return Lanes<T>::max(Lanes<T>::add(a, b), c);
}

// op(a, b) on every lane; select keeps a's lanes where a > b, b's where
// not (a select, not a max).
template <typename T, int OP>
__device__ __forceinline__ uint32_t lane_op(uint32_t a, uint32_t b) {
  using L = Lanes<T>;
  if constexpr (OP == ADD) {
    return L::add(a, b);
  } else if constexpr (OP == MAX) {
    return L::max(a, b);
  } else if constexpr (OP == GT) {
    return L::gt(a, b) & L::ONE;
  } else {
    const uint32_t m = L::gt(a, b);
    return (a & m) | (b & ~m);
  }
}

template <typename O>
__device__ __forceinline__ uint32_t out_bits(O v) {
  if constexpr (std::is_same<O, float>::value)
    return __float_as_uint(v);
  else
    return (uint32_t)v;
}

template <typename T, typename O>
__device__ __forceinline__ O lane_out(uint32_t w, int k) {
  if constexpr (std::is_same<O, float>::value)
    return Lanes<T>::f32(w, k);
  else
    return Lanes<T>::i32(w, k);
}

// One warp a block: at the probes' 8,192 values the grid is 16 (int8)
// to 64 (32-bit) blocks, spread over as many SMs; with four warps a block
// the int8 cases, 64 output bytes a thread, ran ~0.3 us longer on the
// device (PERF.md).
constexpr int BINOP_THREADS = 32;

// out = op(x, y) (rounds = 0), or c <- op(c, y) cut to T, `rounds` times
// from c = x (the probes' fori_loop carry; op(x, y) is its first round),
// then converted to O (int32 or float32). A thread takes V = 16 / sizeof(T)
// values: one 16-byte load an operand, 4 words of packed lanes through
// the rounds, V * 4 / 16 16-byte stores. Where the inputs or the output
// are not 16-byte aligned (vec false), and for the last n % V values, the
// thread takes its values one at a time through the same lane ops (lane
// 0 of a word).
template <typename T, typename O, int OP>
__global__ void __launch_bounds__(BINOP_THREADS)
binop_kernel(const T* __restrict__ x, const T* __restrict__ y, int n,
             int rounds, bool vec, O* __restrict__ out) {
  using L = Lanes<T>;
  constexpr int V = 16 / sizeof(T);
  const int i0 = (blockIdx.x * BINOP_THREADS + threadIdx.x) * V;
  if (i0 >= n) return;
  const int steps = rounds > 0 ? rounds : 1;
  if (vec && i0 + V <= n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + i0));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(y + i0));
    uint32_t c[4] = {a.x, a.y, a.z, a.w};
    const uint32_t d[4] = {b.x, b.y, b.z, b.w};
    for (int r = 0; r < steps; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) c[k] = lane_op<T, OP>(c[k], d[k]);
    }
    uint32_t v[V];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int l = 0; l < L::N; ++l)
        v[k * L::N + l] = out_bits(lane_out<T, O>(c[k], l));
    }
    uint4* o = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
    for (int j = 0; j < V / 4; ++j)
      o[j] = make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
    const int end = min(i0 + V, n);
    for (int i = i0; i < end; ++i) {
      uint32_t c = to_bits(x[i]);
      const uint32_t d = to_bits(y[i]);
      for (int r = 0; r < steps; ++r) c = lane_op<T, OP>(c, d);
      out[i] = lane_out<T, O>(c, 0);
    }
  }
}

template <typename O>
int binop_launch(const void* x, const void* y, int n, int dtype, int op,
                 int rounds, void* out, int device, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (op < ADD || op > SEL || rounds < 0) return (int)cudaErrorInvalidValue;
  const DeviceGuard on(device);
  const bool vec =
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)out) & 15) == 0;
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = 16 / sizeof(T);
    const int threads = (n + V - 1) / V;
    const int grid = (threads + BINOP_THREADS - 1) / BINOP_THREADS;
    const T* xt = static_cast<const T*>(x);
    const T* yt = static_cast<const T*>(y);
    O* o = static_cast<O*>(out);
    cudaStream_t s = as_stream(stream);
    switch (op) {
      case ADD:
        binop_kernel<T, O, ADD><<<grid, BINOP_THREADS, 0, s>>>(
            xt, yt, n, rounds, vec, o);
        break;
      case MAX:
        binop_kernel<T, O, MAX><<<grid, BINOP_THREADS, 0, s>>>(
            xt, yt, n, rounds, vec, o);
        break;
      case GT:
        binop_kernel<T, O, GT><<<grid, BINOP_THREADS, 0, s>>>(
            xt, yt, n, rounds, vec, o);
        break;
      default:
        binop_kernel<T, O, SEL><<<grid, BINOP_THREADS, 0, s>>>(
            xt, yt, n, rounds, vec, o);
    }
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The launch floor: an empty kernel, one warp. probe_noop_launch
// (probe_subint32.cu) takes P1's argument list, so that ctypes
// marshals for it what it marshals for a probe launch, and launches
// this kernel only when `launch` is non-zero: with 0 it times the ctypes
// call alone, with 1 the call and the launch, and its device time is
// what a launch of no work costs on the card.
template <int N>
__global__ void __launch_bounds__(32) noop_kernel() {}

inline int noop_launch(int launch, int device, void* stream) {
  if (!launch) return (int)cudaSuccess;
  const DeviceGuard on(device);
  noop_kernel<0><<<1, 32, 0, as_stream(stream)>>>();
  return (int)cudaGetLastError();
}

}  // namespace probe
