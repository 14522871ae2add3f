// Minimizer lookup against a hash-range-sharded key table: for every
// (shard, query) pair, the query hash's (start, count) in that shard's
// slice of the index, or (0, 0) where the shard does not hold the key.
//
// Replaces the per-shard half of minialign_tpu/parallel/shard.py:95
// (make_sharded_lookup, jitted at :123; XLA, no Pallas): its _local
// searchsorted + found test (:101-107). The cross-shard psum (:112-114)
// is the wrapper's sum over the shard axis
// (minialign_tpu_torch/parallel/cuda_lookup.py), held against
// lookup_plain there. For shard s and query q:
//   idx   = lower_bound(keys[s, :], q)          (first key >= q)
//   found = keys[s, min(idx, K - 1)] == q
//   start = found ? starts[s, idx] : 0,  count = found ? counts[s, idx] : 0
// keys[s, :] is sorted ascending as uint64 and padded with UINT64_MAX
// (parallel/shard.py:shard_index_arrays), so the comparison is unsigned.
// A query equal to the pad value finds a pad slot, whose start and
// count are 0, as in the JAX function.
//
// One thread a (shard, query) pair, blockIdx.y the shard. What bounds it
// on this card: each query's ~log2(K) loads depend one on the next, so a
// lookup is a chain of memory latencies (the top levels of the search
// stay in L2, the last ones go to HBM for a table past 50 MB), not the
// bytes it moves (~8 log2(K) + 40 a pair) or its few integer ops. The
// design keeps many independent chains in flight (one a thread, 256
// threads a block, blocks over queries x shards) and loads through the
// read-only path; the search is branch-light (a select a level).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
lookup_kernel(const unsigned long long* __restrict__ keys,
              const long long* __restrict__ starts,
              const long long* __restrict__ counts, long long K,
              const unsigned long long* __restrict__ q, long long Q,
              long long* __restrict__ st, long long* __restrict__ cn) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= Q) return;
  const long long off = (long long)blockIdx.y * K;
  const unsigned long long* k = keys + off;
  const unsigned long long h = __ldg(q + i);
  long long lo = 0, n = K;
  while (n > 0) {
    const long long half = n >> 1;
    const bool less = __ldg(k + lo + half) < h;
    lo = less ? lo + half + 1 : lo;
    n = less ? n - half - 1 : half;
  }
  const long long ic = lo < K - 1 ? lo : K - 1;
  const bool found = __ldg(k + ic) == h;
  const long long o = (long long)blockIdx.y * Q + i;
  st[o] = found ? __ldg(starts + off + ic) : 0;
  cn[o] = found ? __ldg(counts + off + ic) : 0;
}

}  // namespace

// keys, starts, counts: S shards of K (>= 1) words each, row-major; q: Q
// query hashes; st, cn: (S, Q) outputs, row-major. Every pointer 8-byte
// aligned.
extern "C" int lookup_launch(const void* keys, const void* starts,
                             const void* counts, int S, long long K,
                             const void* q, long long Q, void* st, void* cn,
                             void* stream) {
  if (S < 0 || S > 65535 || K < 1 || Q < 0 ||
      ((uintptr_t)keys | (uintptr_t)starts | (uintptr_t)counts |
       (uintptr_t)q | (uintptr_t)st | (uintptr_t)cn) % 8)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || Q == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((Q + THREADS - 1) / THREADS), (unsigned)S);
  lookup_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<const long long*>(starts),
      static_cast<const long long*>(counts), K,
      static_cast<const unsigned long long*>(q), Q,
      static_cast<long long*>(st), static_cast<long long*>(cn));
  return (int)cudaGetLastError();
}
