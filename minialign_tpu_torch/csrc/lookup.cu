// Minimizer lookup against a hash-range-sharded key table: for every
// query, the sum over the shards of the table on this device of the
// query hash's (start, count) in that shard, (0, 0) where the shard does
// not hold the key.
//
// Replaces minialign_tpu/parallel/shard.py:95 (make_sharded_lookup,
// jitted at :123; XLA, no Pallas): its _local searchsorted + found test
// (:101-107) and its psum (:112-114) over the shards that share a
// device (the sum over devices is the wrapper's caller's,
// parallel/shard.py:sharded_lookup). Held against
// parallel/cuda_lookup.py:lookup_plain. For shard s and query q:
//   idx   = lower_bound(keys[s, :], q)          (first key >= q)
//   found = keys[s, min(idx, K - 1)] == q
//   start = found ? starts[s, idx] : 0,  count = found ? counts[s, idx] : 0
// keys[s, :] is sorted ascending as uint64 and padded with UINT64_MAX
// (parallel/shard.py:shard_index_arrays), so the comparison is unsigned.
// A query equal to the pad value finds a pad slot, whose start and
// count are 0, as in the JAX function.
//
// What bounds it on this card: a lookup is a chain of dependent loads,
// not its few integer ops; at a few thousand queries (one read's hashes,
// the main path) one chain's latency, at hundreds of thousands L2's
// bandwidth (a tree that fits in L2) or HBM's (one that does not). A
// binary search (the first port) makes ~log2(K) dependent loads a
// (shard, query) pair. The design (each choice measured with kbench.py
// --lookup on an H100, PERF.md):
// - A static search tree of 128-byte nodes (cuda_lookup.build_tree, built
//   once a table). An internal node holds 16 separators, one line, and
//   has 17 children; a leaf block holds 15 keys and then the next block's
//   first, so the key at lower_bound always lies in the block it falls
//   into: the found test is an equality over the block's words, and
//   nothing is carried down the levels. ~log17(K / 15) + 1 dependent
//   loads, not ~log2(K). Starts and counts are one (K, 2) pair table, so
//   a hit is one 16-byte load.
// - A query walks only the shards whose key range [first, last] holds it
//   (lower_bound finds it in no other): one shard for a key of a table
//   split by hash range. The hits are summed in registers, the psum of
//   the device's shards. One (2, Q) output.
// - A level is read whole, 4 lanes a query each loading 4 words (two
//   16-byte loads) of the line, joined by warp votes (few queries, or a
//   tree in HBM, whose bursts make a sector no cheaper than a line), or
//   by sectors (split), one thread a query reading the node's 32-byte
//   summary (its words 3, 7, 11, 15) and then the one sector where the
//   count ends: a quarter of the bytes a level for an L2-resident tree
//   under many queries. The wrapper picks (cuda_lookup.use_split). 8 or
//   16 lanes a query, 4 lanes by sectors, and blocks of 64 or 128
//   threads were no faster (PERF.md).
// - The top levels that fit in SMEM_BUDGET (2 levels at 2 shards) are
//   staged once a block in shared memory, on a persistent grid of as
//   many blocks as the SMs hold, each looping over the queries; more (31
//   KB a block at 3 levels) cost more to stage than they save over L1
//   hits, and 0, 1 or 2 levels are within 5% of each other.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr int BLOCK = 256;       // threads a block
constexpr int TPQ = 4;           // lanes a query, levels read whole
constexpr int KL = 16 / TPQ;     // words a lane of a node
constexpr int SMEM_BUDGET = 4096;  // bytes a block for the top levels
constexpr int NK = 16;           // words a node: 128 bytes
constexpr int FAN = NK + 1;      // children an internal node
constexpr int LB = NK - 1;       // keys a leaf block (then the next's first)
constexpr int MAXH = 20;         // internal levels (17^19 x 15 keys: any table)
constexpr int MAXS = 64;         // shards a device (a bit each)
constexpr int MAXDEV = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Tree {
  long long K, B, N;    // keys, leaf blocks, internal nodes a shard
  long long Ts;         // nodes a shard in shared memory (the top T levels)
  int H, T;             // internal levels; levels in shared memory
  long long off[MAXH];  // each level's first node, root first
};

template <bool SMEM>
__device__ __forceinline__ ulonglong2 ld2(const u64* p) {
  const ulonglong2* v = reinterpret_cast<const ulonglong2*>(p);
  return SMEM ? *v : __ldg(v);
}

// Node k of the level at o in shard s's table, from shared memory (SMEM)
// or from the node table (base; stride nodes a shard): its count of
// words < h. Whole (one 128-byte line; lane `sub` of the query's 4,
// whose bits in the warp are gm, holds words 4 sub .. 4 sub + 3) or,
// SPLIT, by sectors by one thread: the node's summary (its words 3, 7,
// 11, 15; sums) says which of its four sectors the count ends in (j =
// #words 3, 7, 11 < h), and that sector alone is read, two dependent
// 32-byte loads. eq (EQ): whether a word read equals h.
template <bool SPLIT, bool SMEM, bool EQ = false>
__device__ __forceinline__ int count(const u64* base, const u64* sums,
                                     long long node, u64 h, int sub,
                                     unsigned gm, bool* eq = nullptr) {
  const u64* p;
  int c = 0;
  if constexpr (SPLIT) {
    const ulonglong2 a = ld2<SMEM>(sums + node * 4);
    const ulonglong2 b = ld2<SMEM>(sums + node * 4 + 2);
    const int j = (a.x < h) + (a.y < h) + (b.x < h);
    p = base + node * NK + 4 * j;
    c = 4 * j;
  } else {
    p = base + node * NK + sub * KL;
  }
  const ulonglong2 x = ld2<SMEM>(p), y = ld2<SMEM>(p + 2);
  const u64 w[4] = {x.x, x.y, y.x, y.y};
  bool e = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (SPLIT)
      c += w[k] < h;
    else
      c += __popc(__ballot_sync(FULL, w[k] < h) & gm);
    e |= w[k] == h;
  }
  if constexpr (EQ) *eq = SPLIT ? e : (__ballot_sync(FULL, e) & gm) != 0;
  return c;
}

template <bool SPLIT>
__global__ void __launch_bounds__(BLOCK)
lookup_kernel(const u64* __restrict__ leaf, const u64* __restrict__ nodes,
              const u64* __restrict__ leaf_sums,
              const u64* __restrict__ node_sums,
              const longlong2* __restrict__ pairs,
              const ulonglong2* __restrict__ bounds, const Tree tr, int S,
              const u64* __restrict__ q, long long Q,
              long long* __restrict__ out) {
  extern __shared__ ulonglong2 sm[];
  // the top levels: shard s's first Ts nodes at sm[s Ts 8 ..], then (to
  // read them by sectors) their summaries at sm[S Ts 8 + s Ts 2 ..]
  const long long per = tr.Ts * (NK / 2);
  for (long long w = threadIdx.x; w < S * per; w += blockDim.x) {
    const long long s = w / per;
    sm[w] = __ldg(reinterpret_cast<const ulonglong2*>(nodes + s * tr.N * NK) +
                  (w - s * per));
  }
  if constexpr (SPLIT) {
    for (long long w = threadIdx.x; w < S * tr.Ts * 2; w += blockDim.x) {
      const long long s = w / (tr.Ts * 2);
      sm[S * per + w] = __ldg(
          reinterpret_cast<const ulonglong2*>(node_sums + s * tr.N * 4) +
          (w - s * tr.Ts * 2));
    }
  }
  __syncthreads();
  const u64* top = reinterpret_cast<const u64*>(sm);
  const u64* top_sums = top + S * tr.Ts * NK;
  constexpr int L = SPLIT ? 1 : TPQ;   // lanes a query
  constexpr int QW = 32 / L;           // queries a warp
  const int lane = threadIdx.x & 31, sub = lane % L;
  const unsigned gm = ((1u << L) - 1) << (lane - sub);
  const int wpb = BLOCK / 32;
  const long long step = (long long)gridDim.x * wpb * QW;
  // warp-uniform trip counts: a query's lanes vote together
  for (long long i0 = ((long long)blockIdx.x * wpb + threadIdx.x / 32) * QW;
       i0 < Q; i0 += step) {
    const long long i = i0 + lane / L;
    const bool ok = i < Q;
    const u64 h = __ldg(q + (ok ? i : Q - 1));
    // the shards whose key range [first, last] holds h: lower_bound finds
    // h in no other (below the range it stops at the first key, above it
    // at the last), so the others add nothing to the sum
    u64 cand = 0;
    for (int s = 0; s < S; ++s) {
      const ulonglong2 r = __ldg(bounds + s);
      cand |= (u64)(h >= r.x && h <= r.y) << s;
    }
    const int nc = __popcll(cand);
    const int rounds = __reduce_max_sync(FULL, (unsigned)nc);
    long long st = 0, cn = 0;
    for (int it = 0; it < rounds; ++it) {
      const bool live = it < nc;
      const int s = live ? __ffsll(cand) - 1 : 0;
      cand &= cand - 1;
      long long k = 0;
      for (int d = 0; d < tr.T; ++d)
        k = k * FAN + count<SPLIT, true>(
            top, top_sums, s * tr.Ts + tr.off[d] + k, h, sub, gm);
      for (int d = tr.T; d < tr.H; ++d)
        k = k * FAN + count<SPLIT, false>(
            nodes, node_sums, s * tr.N + tr.off[d] + k, h, sub, gm);
      // the leaf block's last word is the next block's first key, >= h,
      // so the key at lower_bound is among the words read
      bool eq;
      const long long idx =
          k * LB + count<SPLIT, false, true>(leaf, leaf_sums, s * tr.B + k,
                                             h, sub, gm, &eq);
      if (live && eq && idx < tr.K) {
        const longlong2 p = __ldg(pairs + s * tr.K + idx);
        st += p.x;
        cn += p.y;
      }
    }
    if (ok && sub == 0) {
      out[i] = st;
      out[Q + i] = cn;
    }
  }
}

typedef void (*Kernel)(const u64*, const u64*, const u64*, const u64*,
                       const longlong2*, const ulonglong2*, const Tree, int,
                       const u64*, long long, long long*);

// per device and kernel (whole, split): blocks an SM holds at the most
// shared memory a launch asks for (SMEM_BUDGET). Races between host
// threads only repeat the query: the grid's size never changes a result.
int occupancy[MAXDEV][2], n_sm[MAXDEV];

// Makes `device` current for the launch when it is not already, and gives
// the caller's device back after.
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

}  // namespace

// leaf: S x B x 16 words (B = ceil(K / 15) leaf blocks of 15 keys and
// the next block's first); nodes: S x N x 16 words, the internal levels
// root first; leaf_sums, node_sums: S x B x 4 and S x N x 4 words, the
// words 3, 7, 11 and 15 of each (parallel/cuda_lookup.py:build_tree);
// pairs: S x K (start, count) pairs; bounds: S (first, last) keys of the
// rows; q: Q hashes; out: (2, Q), row-major, the starts then the counts
// summed over the S shards. split: the levels read by sectors. The top
// levels that fit in SMEM_BUDGET bytes (with their summaries when split)
// are staged in shared memory (cuda_lookup.smem_levels). Every table
// 16-byte aligned, q and out 8-byte aligned.
extern "C" int lookup_launch(const void* leaf, const void* nodes,
                             const void* leaf_sums, const void* node_sums,
                             const void* pairs, const void* bounds, int S,
                             long long K, const void* q, long long Q,
                             void* out, int split, int device,
                             void* stream) {
  if (S < 1 || S > MAXS || K < 1 || Q < 0 || device < 0 ||
      device >= MAXDEV ||
      ((uintptr_t)leaf | (uintptr_t)nodes | (uintptr_t)leaf_sums |
       (uintptr_t)node_sums | (uintptr_t)pairs | (uintptr_t)bounds) % 16 ||
      ((uintptr_t)q | (uintptr_t)out) % 8)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  Tree tr;
  long long cnt[MAXH];
  long long n = (K + LB - 1) / LB;
  tr.K = K;
  tr.B = n;
  tr.H = 0;
  while (n > 1) {
    if (tr.H == MAXH) return (int)cudaErrorInvalidValue;
    n = (n + FAN - 1) / FAN;
    cnt[tr.H++] = n;
  }
  // the top levels, root first, while S shards' of them fit the budget
  const size_t node_bytes = (split ? NK + 4 : NK) * sizeof(u64);
  long long o = 0;
  tr.Ts = 0;
  tr.T = 0;
  for (int d = 0; d < tr.H; ++d) {
    tr.off[d] = o;
    o += cnt[tr.H - 1 - d];
    if (tr.T == d && (size_t)S * o * node_bytes <= SMEM_BUDGET) {
      tr.T = d + 1;
      tr.Ts = o;
    }
  }
  tr.N = o;
  DeviceGuard guard(device);
  const Kernel fn = split ? lookup_kernel<true> : lookup_kernel<false>;
  int& nb = occupancy[device][split != 0];
  if (nb == 0) {
    cudaError_t e = cudaDeviceGetAttribute(
        &n_sm[device], cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fn, BLOCK,
                                                        SMEM_BUDGET);
    if (e != cudaSuccess) return (int)e;
    if (nb < 1) nb = 1;
  }
  const size_t smem = (size_t)S * tr.Ts * node_bytes;
  const long long need = (Q * (split ? 1 : TPQ) + BLOCK - 1) / BLOCK;
  const long long most = (long long)n_sm[device] * nb;
  const unsigned grid = (unsigned)(need < most ? need : most);
  fn<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(leaf), static_cast<const u64*>(nodes),
      static_cast<const u64*>(leaf_sums), static_cast<const u64*>(node_sums),
      static_cast<const longlong2*>(pairs),
      static_cast<const ulonglong2*>(bounds), tr, S,
      static_cast<const u64*>(q), Q, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
