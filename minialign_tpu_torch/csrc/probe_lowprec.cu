// P2: low-precision add / max / compare / select, the 8-round carries,
// and the band-step timer, in int16 / int8 / bf16 / f32 / int32.
//
// Replaces tests/tools/probe_lowprec.py:elementwise, :in_carry,
// :roll_concat and :step_timer (Pallas, TPU) and is held against
// minialign_tpu_torch/probes/lowprec.py's *_plain twins, bit for bit.
//
// elementwise / in_carry: probe_common.cuh:binop_kernel, one
// instantiation per (dtype, op): 16-byte loads, the op on packed lanes
// (bf16: __hadd2, __hmax2, __hgt2_mask), the result widened to float32
// with 16-byte stores. What bounds it at (64, 128): the launch.
//
// roll_concat / step_timer: the fill's own layout (fill.cu): one warp
// per column of W = 64 rows, rows t and t + 32 on thread t, all state in
// registers for the whole loop; the row roll concatenate([a[1:], 0]) is
// taken only when the column's direction d[col] > i % 7 holds, which is
// warp-uniform, as the fill's down/up branch is. A step_timer step is,
// for each of the 4 arrays a (old values throughout):
//   a <- max((d ? roll_up(a) : a) + 1, arrs[0]).
// int32 and float32 keep a value a register, four columns a block: the
// roll is fill.cu's roll_up (two __shfl_down_sync and one __shfl_sync),
// max(x + 1, y) the DPX __viaddmax_s32 for int32. The column comes from
// the thread index there, so the compiler cannot see that the roll's
// branch is uniform and wraps every shuffle in convergence barriers
// (WARPSYNC, BSSY / BSYNC): those, not the arithmetic, are most of a
// step (PERF.md).
// int16, bf16 (and int8 in roll_concat) pack rows t and t + 32 into one
// 32-bit word, two lanes, as the TPU packs a 16-bit array two rows to a
// sublane word, and run one column a block: the roll is one
// __shfl_down_sync of the word and, on thread 31, thread 0's high lane
// moved down with 0 above (one __shfl_sync, one __byte_perm); a step is
// one select and one __viaddmax_s16x2 (int16: add and max wrap per lane,
// one VIADDMNMX.S16x2) or __hmax2(__hadd2(a, 1), f0) (bf16) a word: two
// shuffles a roll instead of three, one or two instructions a step
// instead of four, and no convergence barriers.
// What bounds a step: the dependent chain shuffle -> select -> add-max of
// one warp. B = 128 columns leave most schedulers with one warp or none:
// latency; B = 1024 put ~2 warps on each: latency still, by the packed
// kernels' measured times, which hardly move from 128 to 1024.

#include "probe_common.cuh"

namespace {

using namespace probe;

constexpr int WARPS = 4;  // columns per block
constexpr int N_ARR = 4;  // probe_lowprec.step_timer's n_arr

// roll_up on packed words: thread t takes thread t + 1's word (rows t + 1
// and t + 33); thread 31 takes row 32, thread 0's high half, into its low
// half and 0 (row 64) above.
__device__ __forceinline__ uint32_t roll_up_pair(uint32_t w, int t) {
  const uint32_t down = __shfl_down_sync(FULL, w, 1);
  const uint32_t top = __shfl_sync(FULL, w, 0);
  return t == 31 ? __byte_perm(top, 0, 0x4432) : down;
}

// The packed kernels run one warp a block, column blockIdx.x: the
// column, its direction and so the roll's branch are uniform to the
// compiler, which then puts no convergence barrier around the shuffles.
template <typename T>
__global__ void __launch_bounds__(32)
roll_concat_pair_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        int B, int rounds, float* __restrict__ out) {
  using L = Lanes<T>;
  const int t = threadIdx.x;
  const int col = blockIdx.x;
  uint32_t w = Pair<T>::pack(x[t * B + col], x[(t + 32) * B + col]);
  const bool d = gt(y[col], y[B + col]);  // y[0:1] > y[1:2]
  const uint32_t one = Pair<T>::splat(1);
  for (int r = 0; r < rounds; ++r) {
    if (d) w = roll_up_pair(w, t);
    w = L::add(w, one);
  }
  out[t * B + col] = L::f32(w, 0);
  out[(t + 32) * B + col] = L::f32(w, Pair<T>::HI);
}

template <typename T>
__global__ void __launch_bounds__(32)
step_timer_pair_kernel(const T* __restrict__ x,
                       const int32_t* __restrict__ dd, int B, int n_steps,
                       float* __restrict__ out) {
  using L = Lanes<T>;
  const int t = threadIdx.x;
  const int col = blockIdx.x;
  const uint32_t x2 = Pair<T>::pack(x[t * B + col], x[(t + 32) * B + col]);
  uint32_t a[N_ARR];
#pragma unroll
  for (int k = 0; k < N_ARR; ++k) a[k] = L::add(x2, Pair<T>::splat(k));
  const int dcol = dd[col];
  const uint32_t one = Pair<T>::splat(1);
  int im7 = 0;  // i % 7
  for (int i = 0; i < n_steps; ++i) {
    const bool d = dcol > im7;
    im7 = im7 == 6 ? 0 : im7 + 1;
    const uint32_t f0 = a[0];
#pragma unroll
    for (int k = 0; k < N_ARR; ++k) {
      if (d) a[k] = roll_up_pair(a[k], t);
      a[k] = addmax_pair<T>(a[k], one, f0);
    }
  }
  uint32_t m = a[0];
#pragma unroll
  for (int k = 1; k < N_ARR; ++k) m = L::max(m, a[k]);
  out[t * B + col] = L::f32(m, 0);
  out[(t + 32) * B + col] = L::f32(m, Pair<T>::HI);
}

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

// the types whose step timer runs in packed pairs
template <typename T>
constexpr bool paired_16 =
    std::is_same<T, int16_t>::value || std::is_same<T, __nv_bfloat16>::value;

}  // namespace

extern "C" int p2_elementwise_launch(const void* x, const void* y, int n,
                                     int dtype, int op, int rounds,
                                     void* out, int device, void* stream) {
  return binop_launch<float>(x, y, n, dtype, op, rounds, out, device,
                             stream);
}

// x, y: (64, B) of the dtype; out (64, B) float32. int16, bf16 and int8
// in packed pairs, the other types a value a register.
extern "C" int p2_roll_concat_launch(const void* x, const void* y, int B,
                                     int dtype, int rounds, void* out,
                                     int device, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int grid = (B + WARPS - 1) / WARPS;
    const T* xt = static_cast<const T*>(x);
    const T* yt = static_cast<const T*>(y);
    float* o = static_cast<float*>(out);
    if constexpr (paired_16<T> || std::is_same<T, int8_t>::value)
      roll_concat_pair_kernel<T><<<B, 32, 0, as_stream(stream)>>>(
          xt, yt, B, rounds, o);
    else
      roll_concat_kernel<T><<<grid, WARPS * 32, 0, as_stream(stream)>>>(
          xt, yt, B, rounds, o);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x: (64, B) of the dtype; dd: (B,) int32; out (64, B) float32. int16 and
// bf16 in packed pairs, the other types a value a register.
extern "C" int p2_step_timer_launch(const void* x, const void* dd, int B,
                                    int dtype, int n_steps, void* out,
                                    int device, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const DeviceGuard on(device);
  const bool ok = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const int grid = (B + WARPS - 1) / WARPS;
    const T* xt = static_cast<const T*>(x);
    const int32_t* d = static_cast<const int32_t*>(dd);
    float* o = static_cast<float*>(out);
    if constexpr (paired_16<T>)
      step_timer_pair_kernel<T><<<B, 32, 0, as_stream(stream)>>>(
          xt, d, B, n_steps, o);
    else
      step_timer_kernel<T><<<grid, WARPS * 32, 0, as_stream(stream)>>>(
          xt, d, B, n_steps, o);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
