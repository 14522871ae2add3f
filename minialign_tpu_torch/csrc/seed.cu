// Round-0 seed collection of a whole read batch (mm_collect_seed,
// minialign.c:3454-3493): the (w,k)-minimizer sketch of every read, the
// two-stage lookup in the bucket-major index, the drop / rescue / expand
// classification and mm_expand (minialign.c:3420-3446), in one pass.
//
// It replaces no TPU kernel: the JAX package seeds on the host, one read a
// call (chain.collect_seeds, through the host library's collect_seeds_c).
// It was added because that per-read host call was about half of a mapping
// window while the card stood idle. It is held against
// minialign_tpu_torch/index/seed_device.py:seed_pass_plain, word for word,
// and that against native.collect_seeds, read by read; its tiles are
// modelled in numpy in tests/test_torch_seed_device.py
// (seed_count_model).
//
// For each read r of the pass (codes taken & 3: N counts as A) and each
// k-mer position p in [0, n_r), n_r = L_r - k + 1:
//   k0, k1  the forward k-mer and its reverse complement (2 bits a base)
//   strand  k1 <= k0 (a palindrome takes the reverse strand)
//   h       strand ? k1 : k0. collect_seeds_c's (crc32c(kx) ^ km) & mask
//           is km: the CRC term is 0 for every kx < 2^32 (the proof at
//           csrc/sketch.cu:hash_segment), and k <= 16 keeps kx there
//   v       h << 8 | p % w | strand << 7
//   m, a    the least v over the window [p - w + 1, p] clipped at 0, and
//           its position; a window's v differ in p % w, so a is unique
//           and sketch_seq's tie rule never decides
//   emit    p == 0, or m differs from position p - 1's, or a == p
// Each emitted (h = m >> 8, strand, pos = a) is looked up as
// collect_seeds_c does: lower_bound of h in keys[bkt_off[h & (2^b - 1)],
// bkt_off[(h & (2^b - 1)) + 1]); start = offsets[key], cnt = offsets[key +
// 1] - start, qs = strand ? ~(pos + k) : pos. A missing key, cnt == 0 and
// cnt > max_occ are dropped; occ0 < cnt <= max_occ gives a rescue row
// (qs, cnt, start); the rest expand into cnt seeds (upos, vpos, rid) in
// index order. Seeds and rescue rows come out in read order, then
// minimizer order.
//
// Three launches a pass:
//   seed_count  a block a tile of TILE positions of one read, in shared
//               memory: its codes packed 16 to a word beside their
//               reverse complements, so that a k-mer pair is two funnel
//               shifts (sketch_core.cuh, shared with the device sketch
//               S1), v a slot (a halo of w positions before the tile),
//               the windows' minima by S1's sliding minimum (van Herk /
//               Gil-Werman on w-blocks of slots: a block's prefix and
//               suffix minima, then one minimum a slot, about three in
//               all whatever w is; a block's passes split over up to 32
//               threads by S1's rules, seed_device.lanes, where the
//               blocks leave threads idle, w >= 17; slots kept as S1
//               keeps them, [offset in w-block][w-block] with an odd
//               row, so that no pass meets a bank conflict), the emitted
//               minimizers compacted in position order, then looked up,
//               one a thread at a time; each one's (qs, start, cnt) into
//               the tile's slots of rec (cnt 0 where dropped), and the
//               tile's counts
//   seed_scan   one block: exclusive sums of seeds and rescue rows over the
//               tiles, and at each read's first tile
//   seed_write  a block a tile: each run's seeds or rescue row, at its
//               tile's sum plus the runs before it in the tile
// The host reads the per-read sums back after seed_scan (they size the
// output) and the output once after seed_write.
//
// What bounds it on this card: bytes and the latency of dependent loads,
// not operations (some tens of integer instructions a position, tens of
// us for an 8 MiB batch of 8.4 M positions). The least bytes are a code a position, an
// emitted minimizer's bucket head, key and run (32 B), and a seed's
// vals_pos and vals_rid read and upos, vpos and rid written (20 B):
// seed_device.pass_bytes, ~0.02 ms for such a batch at 3.35 TB/s. A
// lookup's binary search is a chain of ~log2(bucket) dependent loads
// (~11 at dm6's ~1,600 keys a bucket, 2-6 at E. coli's ~56), each a
// 32-byte sector of a table far beyond the L2 cache. The design keeps as
// many of those chains in flight as the card holds threads: the emitted
// minimizers of a tile are compacted first, so every lane of a warp walks
// its own search and none waits on an empty position. (A warp-cooperative
// search, 32 lanes probing one key's bucket at 32 spaced keys, takes 3
// rounds at 1,600 keys but serialises a warp's ~40 minimizers and reads
// ~4 times the sectors.) A search's last probes share a 128-byte line,
// so the searches want the SM's L1: a tile is TILE = 1,024 positions,
// whose codes, v and window minima never leave 19,584 B of shared memory
// (the packed codes in the minima's words), so that the six blocks an SM
// holds (40 registers a thread) take a small shared-memory carve-out and
// leave the rest of the SM's 256 KB to L1. (At 2,048 positions a tile,
// 35,968 B a block, seed_count took 0.52 ms of device time on one 8 MiB
// batch of dm6's reads against 0.35 at 1,024, and 0.17 ms on E. coli's
// either way.) rec holds 16 B an emitted minimizer, written once and read
// once.

#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_core.cuh"

namespace {

using sketch_core::min64;

constexpr int BLOCK = 256;                 // threads of seed_count, seed_write
constexpr int PER = 4;                     // positions a thread of a tile
constexpr int TILE = BLOCK * PER;          // positions a tile
constexpr int SCAN = 1024;                 // threads of seed_scan
constexpr int MAX_K = 16;
constexpr int MAX_W = 64;
// seed_count's slots: w (nb | 1) for nb = (TILE + 2w - 1) / w w-blocks
// (the tile's positions, the halo, the last block's rest), at most 1,197
// (w = 57) for w <= MAX_W; the packed codes fit in as many 8-byte words
constexpr int SLOTS = 1200;
constexpr uint64_t BIG = ~0ull;            // a position outside [0, n)
constexpr uint64_t VMASK = (1ull << 40) - 1;   // v: h (32 bits) << 8 | lo
constexpr int32_t OFS = 0x40000000;

// The exclusive prefix of x over the block's threads in thread order;
// *total gets the block's sum. buf: 32 words of shared memory. Every
// thread of the block calls it.
template <typename T>
__device__ T block_scan(T x, T* total, T* buf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) buf[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    T s = lane < nw ? buf[lane] : T(0);
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < nw) buf[lane] = s;
  }
  __syncthreads();
  const T before = (wid ? buf[wid - 1] : T(0)) + inc - x;
  *total = buf[nw - 1];
  __syncthreads();
  return before;
}

// desc: the pass's int64 descriptor block, laid out by
// index/seed_device.py:pack_desc
struct Desc {
  const long long* off;     // (R,) a read's first code in the store
  const long long* len;     // (R,) its length
  const long long* tile0;   // (R + 1,) its first tile; [R] = the tiles
  const long long* read;    // (tiles,) a tile's read
  __device__ Desc(const long long* d, int R)
      : off(d), len(d + R), tile0(d + 2 * R), read(d + 3 * R + 1) {}
};

// slot s's word in seed_count's [s % w][s / w] arrays: s / w by wm, the
// low word of 2^32 / w + 1 (1 at w = 1, where s itself is added), exact
// for s * w < 2^32
__device__ __forceinline__ int slot_at(int s, int w, int nbp, uint32_t wm) {
  const int b = (int)__umulhi((uint32_t)s, wm) + (w == 1 ? s : 0);
  return (s - b * w) * nbp + b;
}

__global__ void __launch_bounds__(BLOCK, 6)
seed_count(const int8_t* __restrict__ codes, bool aligned,
           const long long* __restrict__ dp, int R, int k, int w, int S,
           int G, const unsigned long long* __restrict__ keys,
           long long nkeys, const long long* __restrict__ bkt_off, int b,
           const uint32_t* __restrict__ offsets, long long max_occ,
           long long occ0, int4* __restrict__ rec,
           unsigned long long* __restrict__ tile_cnt) {
  // v, then the w-blocks' suffix minima, then the emitted minimizers;
  // and the packed codes, then the prefix minima, then the windows'
  // minima. Slots as [offset in w-block][w-block], nbp words a row, so
  // that neighbouring threads of the passes take neighbouring words
  __shared__ uint64_t sv[SLOTS];
  __shared__ __align__(16) uint64_t sm[SLOTS];
  __shared__ int ibuf[32];
  __shared__ unsigned long long ubuf[32];
  const Desc d(dp, R);
  const int tile = blockIdx.x, t = threadIdx.x;
  const int r = (int)d.read[tile];
  const long long L = d.len[r];
  const long long n = L - k + 1;
  const long long p0 = (tile - d.tile0[r]) * (long long)TILE;
  const long long c0 = p0 - w;             // slot 0's position
  const uint8_t* __restrict__ q =
      reinterpret_cast<const uint8_t*>(codes) + d.off[r];
  const int nb = (TILE + 2 * w - 1) / w;   // w-blocks of slots
  const int nbp = nb | 1;                  // odd: no bank conflicts
  const int ns = nb * w;                   // slots, >= TILE + w
  const uint32_t wm = (uint32_t)(0x100000000ull / (unsigned)w + 1);

  // the packed codes from slot 0's on, the first word at a multiple of
  // 16 in the store (so that its loads are aligned where the store is)
  {
    uint4* sq = reinterpret_cast<uint4*>(sm);
    const long long g0 = d.off[r] + c0;
    const long long gb = g0 & ~15ll;
    const int d0 = (int)(g0 - gb);
    sketch_core::stage_words(sq, q, L, gb - d.off[r],
                             (ns + k - 2 + d0) / 16 + 2, aligned);
    __syncthreads();

    // v of every slot (BIG outside [0, n))
    const int sh = 32 - 2 * k;
    const uint32_t mask = k == 16 ? 0xffffffffu : (1u << (2 * k)) - 1u;
    for (int s = t; s < ns; s += BLOCK) {
      const long long p = c0 + s;
      uint64_t v = BIG;
      if (p >= 0 && p < n) {
        uint32_t k0, k1;
        sketch_core::kmer_pair(sq, s + d0, sh, mask, &k0, &k1);
        const uint32_t strand = k1 <= k0 ? 1u : 0u;
        const uint32_t h = strand ? k1 : k0;
        v = (uint64_t)h << 8 | (uint64_t)(p % w) | (uint64_t)strand << 7;
      }
      sv[slot_at(s, w, nbp, wm)] = v;
    }
  }
  __syncthreads();

  // van Herk / Gil-Werman on the w-blocks [bw, bw + w) of slots: each
  // block's prefix minima into sm and its suffix minima into sv, a block
  // over S lanes of G slots each (S = 1 where the blocks fill the
  // threads), each lane's completed by the minima of the segments before
  // and after its own
  {
    const int ls = __ffs(S) - 1;
    const unsigned gmask =
        S == 32 ? 0xffffffffu : ((1u << S) - 1) << ((t & 31) & ~(S - 1));
    for (int it = t; it < nb * S; it += BLOCK) {
      const int blk = it >> ls, seg = it & (S - 1);
      const int r0 = min(seg * G, w), r1 = min(seg * G + G, w);
      uint64_t pm = BIG, qm = BIG;
      for (int j = r0 * nbp + blk; j < r1 * nbp; j += nbp) {
        pm = min64(pm, sv[j]);
        sm[j] = pm;
      }
      for (int j = (r1 - 1) * nbp + blk; j >= r0 * nbp; j -= nbp) {
        qm = min64(qm, sv[j]);
        sv[j] = qm;
      }
      if (S > 1) {
        uint64_t pre = pm, suf = qm;       // the segment's minimum, both
        for (int dd = 1; dd < S; dd <<= 1) {
          const uint64_t u = __shfl_up_sync(gmask, pre, dd, S);
          const uint64_t v = __shfl_down_sync(gmask, suf, dd, S);
          if (seg >= dd) pre = min64(pre, u);
          if (seg + dd < S) suf = min64(suf, v);
        }
        uint64_t cp = __shfl_up_sync(gmask, pre, 1, S);
        uint64_t cs = __shfl_down_sync(gmask, suf, 1, S);
        if (seg == 0) cp = BIG;
        if (seg == S - 1) cs = BIG;
        for (int j = r0 * nbp + blk; j < r1 * nbp; j += nbp) {
          sm[j] = min64(sm[j], cp);
          sv[j] = min64(sv[j], cs);
        }
      }
    }
  }
  __syncthreads();

  // the window minimum of every slot from w - 1 on (slot w - 1 is the
  // tile's position p0 - 1): slot s = bw + r's window [s - w + 1, s] is
  // block b's prefix to r and block b - 1's suffix from r + 1, or block
  // b whole at r = w - 1
  for (int s = w - 1 + t; s < TILE + w; s += BLOCK) {
    const int a = slot_at(s, w, nbp, wm);
    if (a < (w - 1) * nbp) sm[a] = min64(sm[a], sv[a + nbp - 1]);
  }
  __syncthreads();

  // the emitted minimizers in position order: m with the slot of its
  // position above bit 40 (slots < 2^12), compacted into sv
  int ne = 0;
  for (int i = 0; i < PER; ++i) {
    const int l = i * BLOCK + t;
    const int s = w + l;
    const long long p = p0 + l;
    int e = 0;
    uint64_t x = 0;
    if (p < n) {
      const uint64_t m = sm[slot_at(s, w, nbp, wm)];
      // p - a: a is the window's position whose p % w is m's
      const int back = (int)(((p % w) - (long long)(m & 0x7f) + w) % w);
      e = p == 0 || m != sm[slot_at(s - 1, w, nbp, wm)] || back == 0;
      x = m | (uint64_t)(s - back) << 40;
    }
    int tot;
    const int at = block_scan<int>(e, &tot, ibuf);
    if (e) sv[ne + at] = x;
    ne += tot;
  }
  __syncthreads();

  // lookups, one emitted minimizer a thread at a time
  const uint64_t bmask = (1ull << b) - 1;
  int4* __restrict__ out = rec + (long long)tile * TILE;
  unsigned long long mine = 0;             // rescue rows | seeds << 32
  for (int j = t; j < ne; j += BLOCK) {
    const uint64_t x = sv[j];
    const uint64_t m = x & VMASK;
    const long long pos = c0 + (long long)(x >> 40);
    const unsigned long long h = m >> 8;
    const long long fr = (long long)((m >> 7) & 1);
    long long lo = bkt_off[h & bmask], hi = bkt_off[(h & bmask) + 1];
    while (lo < hi) {                      // lower_bound
      const long long mid = (lo + hi) >> 1;
      if (keys[mid] < h)
        lo = mid + 1;
      else
        hi = mid;
    }
    long long start = 0, cnt = 0;
    if (lo < nkeys && keys[lo] == h) {
      start = offsets[lo];
      cnt = (long long)offsets[lo + 1] - start;
      if (cnt < 0 || cnt > max_occ) cnt = 0;
    }
    const int qs = (int)((pos + k * fr) ^ -fr);
    out[j] = make_int4(qs, (int)(uint32_t)start, (int)cnt, 0);
    if (cnt > occ0)
      mine += 1;
    else
      mine += (unsigned long long)cnt << 32;
  }
  unsigned long long tot;
  block_scan<unsigned long long>(mine, &tot, ubuf);
  // rescue rows <= ne <= TILE < 2^16
  if (t == 0) tile_cnt[tile] = tot | (unsigned long long)ne << 16;
}

__global__ void __launch_bounds__(SCAN)
seed_scan(const long long* __restrict__ dp, int R, int ntiles,
          const unsigned long long* __restrict__ tile_cnt,
          long long* __restrict__ tile_pre, long long* __restrict__ read_pre) {
  __shared__ long long buf[32];
  const Desc d(dp, R);
  long long cs = 0, cr = 0;                // seeds, rescue rows so far
  for (int i0 = 0; i0 < ntiles; i0 += SCAN) {
    const int i = i0 + threadIdx.x;
    const unsigned long long x = i < ntiles ? tile_cnt[i] : 0;
    long long ts, tr;
    const long long bs = block_scan<long long>((long long)(x >> 32), &ts, buf);
    const long long br =
        block_scan<long long>((long long)(x & 0xffff), &tr, buf);
    if (i < ntiles) {
      tile_pre[2 * i] = cs + bs;
      tile_pre[2 * i + 1] = cr + br;
    }
    cs += ts;
    cr += tr;
  }
  __syncthreads();
  for (int r = threadIdx.x; r <= R; r += SCAN) {
    const long long t0 = d.tile0[r];
    read_pre[2 * r] = t0 < ntiles ? tile_pre[2 * t0] : cs;
    read_pre[2 * r + 1] = t0 < ntiles ? tile_pre[2 * t0 + 1] : cr;
  }
}

__global__ void __launch_bounds__(BLOCK)
seed_write(const int4* __restrict__ rec,
           const unsigned long long* __restrict__ tile_cnt,
           const long long* __restrict__ tile_pre, int k, long long occ0,
           const uint32_t* __restrict__ vals_pos,
           const uint32_t* __restrict__ vals_rid, long long nseed,
           int32_t* __restrict__ out) {
  __shared__ unsigned long long buf[32];
  const int tile = blockIdx.x, t = threadIdx.x;
  const int ne = (int)((tile_cnt[tile] >> 16) & 0xffff);
  const int4* __restrict__ in = rec + (long long)tile * TILE;
  // a thread's runs are contiguous, so the scan keeps their order
  const int per = (ne + BLOCK - 1) / BLOCK;
  const int j0 = min(t * per, ne), j1 = min(j0 + per, ne);
  unsigned long long mine = 0;
  for (int j = j0; j < j1; ++j) {
    const int cnt = in[j].z;
    if (cnt > occ0)
      mine += 1;
    else
      mine += (unsigned long long)cnt << 32;
  }
  unsigned long long tot;
  const unsigned long long before =
      block_scan<unsigned long long>(mine, &tot, buf);
  long long sa = tile_pre[2 * tile] + (long long)(before >> 32);
  long long ra = tile_pre[2 * tile + 1] + (long long)(before & 0xffffffffu);
  int32_t* __restrict__ up = out;
  int32_t* __restrict__ vp = out + nseed;
  int32_t* __restrict__ rd = out + 2 * nseed;
  int32_t* __restrict__ rs = out + 3 * nseed;
  for (int j = j0; j < j1; ++j) {
    const int4 x = in[j];
    const long long cnt = x.z;
    if (cnt > occ0) {
      rs[3 * ra] = x.x;
      rs[3 * ra + 1] = x.z;
      rs[3 * ra + 2] = x.y;
      ++ra;
      continue;
    }
    const long long qv = x.x;              // sign-extended
    const long long start = (uint32_t)x.y;
    for (long long u = start; u < start + cnt; ++u) {
      const uint32_t rv = vals_rid[u];
      const long long rev = rv & 1;
      const long long xx = (long long)vals_pos[u] + k * rev;
      const long long y = rev ? ~qv : qv;
      up[sa] = (int32_t)(2 * xx - y + OFS);
      vp[sa] = (int32_t)(2 * y - xx + OFS);
      rd[sa] = (int32_t)(rv >> 1);
      ++sa;
    }
  }
}

}  // namespace

// codes: the int8 query store; desc: index/seed_device.py:pack_desc's
// int64 block (R reads, ntiles tiles); keys (uint64), bkt_off (int64, 2^b +
// 1), offsets (uint32, nkeys + 1): the index's bucket-major tables; rec:
// ntiles * TILE int4 slots; tile_cnt: ntiles uint64; tile_pre: 2 * ntiles
// int64; read_pre: 2 * (R + 1) int64, each read's first seed and rescue row
// ([R]: the totals). Launches seed_count (when there is a tile), then
// seed_scan.
extern "C" int seed_count_launch(const void* codes, const void* desc, int R,
                                 int ntiles, int k, int w, int segs,
                                 int seg_len, const void* keys,
                                 long long nkeys, const void* bkt_off, int b,
                                 const void* offsets, long long max_occ,
                                 long long occ0, void* rec, void* tile_cnt,
                                 void* tile_pre, void* read_pre,
                                 void* stream) {
  // segs a power of 2 up to 32 that gives each segment of a tile's
  // w-blocks a thread where > 1, and the segments covering a w-block
  const int nb = (TILE + 2 * w - 1) / (w > 0 ? w : 1);
  if (k < 1 || k > MAX_K || w < 1 || w > MAX_W || b < 0 || b > 32 || R < 0 ||
      ntiles < 0 || nkeys < 0 || max_occ < 0 || occ0 < 0 || segs < 1 ||
      segs > 32 || (segs & (segs - 1)) || (segs > 1 && nb * segs > BLOCK) ||
      seg_len < 1 || segs * seg_len < w || (segs == 1 && seg_len != w) ||
      w * (nb | 1) > SLOTS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* dp = static_cast<const long long*>(desc);
  unsigned long long* tc = static_cast<unsigned long long*>(tile_cnt);
  if (ntiles > 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
    seed_count<<<ntiles, BLOCK, 0, s>>>(
        static_cast<const int8_t*>(codes), aligned, dp, R, k, w, segs,
        seg_len,
        static_cast<const unsigned long long*>(keys), nkeys,
        static_cast<const long long*>(bkt_off), b,
        static_cast<const uint32_t*>(offsets), max_occ, occ0,
        static_cast<int4*>(rec), tc);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  seed_scan<<<1, SCAN, 0, s>>>(dp, R, ntiles, tc,
                               static_cast<long long*>(tile_pre),
                               static_cast<long long*>(read_pre));
  return (int)cudaGetLastError();
}

// out: 3 * nseed + 3 * nresc int32: upos, vpos, rid, then the rescue rows
// (qs, cnt, start as uint32 bits); the other pointers as seed_count_launch
// left them. Launches seed_write.
extern "C" int seed_write_launch(int ntiles, int k, long long occ0,
                                 const void* vals_pos, const void* vals_rid,
                                 const void* rec, const void* tile_cnt,
                                 const void* tile_pre, long long nseed,
                                 void* out, void* stream) {
  if (k < 1 || k > MAX_K || ntiles < 1 || nseed < 0 || occ0 < 0)
    return (int)cudaErrorInvalidValue;
  seed_write<<<ntiles, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rec),
      static_cast<const unsigned long long*>(tile_cnt),
      static_cast<const long long*>(tile_pre), k, occ0,
      static_cast<const uint32_t*>(vals_pos),
      static_cast<const uint32_t*>(vals_rid), nseed,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
