// The (w,k)-minimizer sketch over every k-mer position of one sequence.
//
// Replaces minialign_tpu/index/sketch_jax.py:39 (sketch_device; XLA, no
// Pallas) and is held against
// minialign_tpu_torch/index/sketch_device.py:sketch_device_plain, word
// for word. For each position p in [0, n), n = L - k + 1, of the codes
// taken & 3 (N counts as A):
//   k0, k1   the forward k-mer and its reverse complement (2 bits a base)
//   strand   k1 <= k0 (a palindrome at even k takes the reverse strand)
//   km, kx   strand ? (k1, k0) : (k0, k1)
//   h        (crc32c(kx) ^ km) & (4^k - 1), the CRC as _mm_crc32_u64(kx, kx)
//   lo       (p % w) | strand << 7
//   (mh, ml) the lexicographic minimum of (h, lo) over the trailing
//            window [p - w + 1, p], clipped at the head (a position
//            before 0 counts as (UINT32_MAX, UINT32_MAX)); on a full tie
//            the newer element wins
//   emit     the window's minimum differs from position p - 1's (always
//            at p = 0), or it is p's own (h, lo)
//   pos      p when the minimum is p's own, else the position it came
//            from
// and writes hash = mh, pos, strand = (ml >> 7) & 1 and emit. lo keeps
// its index and strand bit apart only for w <= 128; above that the
// kernel computes what the JAX function computes (the bits overlap
// there too). Supported: 1 <= k <= 16, 1 <= w <= MAX_W, n < 2^31.
//
// What bounds it on this card: 11 bytes a position (a code read; hash,
// pos, strand and emit written) against ~39 32-bit operations a position
// that the function needs (chip_smoke.SKETCH_OPS): the bytes, 0.82 ms at
// 250 Mb against 0.29 ms of operations. The design keeps every
// intermediate in shared memory and spends ~70 instructions a position:
// - No CRC: for kx < 2^32 the CRC is 0 (hash_segment), so h = km.
// - A block takes a tile of tile_blocks(w) * w positions (~2,500: a halo
//   of one window, w + k - 1 codes, is a small share) and stages its
//   codes once, packed 16 to a 32-bit word, first code in the top bits,
//   from 16-byte loads, with each word's reverse complement beside it. A
//   k-mer is then two funnel shifts and a shift or mask: no k-loop
//   (sketch_core.cuh, which the batch seed pass seed.cu shares).
// - The sliding minimum is van Herk / Gil-Werman's on w-aligned blocks
//   of w positions: a thread takes a block, keeps its keys and prefix
//   minima (one pass, which also hashes), then its suffix minima
//   combined with the next block's prefix minima (a second pass): three
//   64-bit minima a position, whatever w is. Where a tile has at
//   most half as many w-blocks as threads (w >= 20), a w-block's passes
//   are split over up to 32 lanes, joined by shuffles, so that no lane
//   takes w serial steps. Key = h << 32 | lo << 21 |
//   (TIE - slot): its order is the JAX function's (h, lo), then the
//   newer slot, so a plain minimum takes the reference's ties and its
//   low bits give the argmin's position for every w (w > 128 too, where
//   lo cannot): one instance serves all w.
// - Keys and minima live in shared memory as [offset in block][block]
//   (neighbouring threads on neighbouring words: no bank conflicts in
//   the passes); the last pass writes four positions a thread with
//   16-byte stores of hash and pos and 4-byte stores of strand and emit.
// - A tile's w-blocks (index/cuda_sketch.py:tile_blocks chooses them) are
//   a multiple of the block's threads where they can be (no thread takes
//   one more than the others between barriers), and its ~44 KB of shared
//   memory let five blocks share an SM, so that one block's staging
//   loads and barriers overlap the others' passes.

#include <cstdint>
#include <cuda_runtime.h>

#include "sketch_core.cuh"

namespace {

using sketch_core::kmer_pair;
using sketch_core::min64;

constexpr int BLOCK = 256;                 // threads a block
constexpr int MAX_W = 1024;
constexpr int MAX_DEVICES = 64;
constexpr uint32_t TIE = (1u << 21) - 1;   // the key's slot field
constexpr uint64_t BIG = ~0ull;            // a position outside [0, n)

// (hash, lo) words of every slot and their prefix minima, then the
// windows' minima: 16 bytes a slot; the packed codes 16 bytes a word
size_t smem_bytes(int k, int w, int blocks) {
  const int nb = blocks + 1;
  const int nw = (nb * w + k + 13) / 16 + 2;
  return 16 * (size_t)w * (nb | 1) + 16 * (size_t)nw;
}

// Pass 1 for the slots [r0, r1) of the w-block b: every slot's key, and
// the running prefix minimum from r0, into K and P at [r][b]; returns the
// segment's minimum. EDGE: the tile reaches past position 0 or n - 1, so
// positions are checked.
template <bool EDGE>
__device__ __forceinline__ uint64_t hash_segment(
    const uint4* __restrict__ Q, uint64_t* __restrict__ K,
    uint64_t* __restrict__ P, int b, int r0, int r1, int w, int nbp, int d0,
    int sh, uint32_t mask, long long base, long long n) {
  const int j0 = b * w + r0;               // the segment's first slot
  int off = j0 + d0;                       // its code in Q's words
  uint32_t c = (uint32_t)r0 << 21 | (TIE - (uint32_t)j0);
  long long q = base + j0;                 // its position
  uint64_t pm = BIG;
  int a = r0 * nbp + b;
  for (int r = r0; r < r1; ++r) {
    uint32_t k0, k1;
    kmer_pair(Q, off, sh, mask, &k0, &k1);
    // The hash, (crc32c(kx) ^ km) & mask, is km = min(k0, k1): for every
    // kx < 2^32, _mm_crc32_u64(kx, kx) == 0. The accumulator starts at
    // kx and takes kx's eight bytes LSB first; by induction it is
    // kx >> 8i before step i < 4 (the table's index is
    // ((kx >> 8i) ^ (kx >> 8i)) & 0xff = 0 and tab[0] == 0), so kx >> 32
    // = 0 after four steps, and the four zero bytes keep it 0. The plain
    // version keeps the CRC: every comparison checks the identity.
    const uint32_t h = min(k0, k1);
    const uint32_t lo = c | (k1 <= k0 ? 1u << 28 : 0u);
    uint64_t key = (uint64_t)h << 32 | lo;
    if (EDGE && (q < 0 || q >= n)) key = BIG;
    pm = min64(pm, key);
    K[a] = key;
    P[a] = pm;
    ++off;
    ++q;
    c += (1u << 21) - 1;                   // (p % w) << 21 | TIE - slot
    a += nbp;
  }
  return pm;
}

// Pass 1: a w-block's S segments of G slots go to S neighbouring lanes
// (S = 1 where the w-blocks fill the threads). A lane hashes its segment
// and keeps its prefix minima; the group's shuffles give it the minimum
// of the segments before its own, which completes them, and of those
// after it, where its suffix starts in pass 2 (returned; BIG for S = 1).
// Where S > 1 a lane takes at most one segment, so it keeps that minimum
// across the barrier.
template <bool EDGE, bool SPLIT>
__device__ __forceinline__ uint64_t pass1(
    const uint4* __restrict__ Q, uint64_t* __restrict__ K,
    uint64_t* __restrict__ P, int nb, int S, int ls, int G, int w, int nbp,
    int d0, int sh, uint32_t mask, long long base, long long n) {
  const int t = threadIdx.x;
  const unsigned gmask =
      S == 32 ? 0xffffffffu : ((1u << S) - 1) << ((t & 31) & ~(S - 1));
  uint64_t cs = BIG;
  for (int it = t; it < nb * S; it += BLOCK) {
    const int b = it >> ls, seg = it & (S - 1);
    const int r0 = min(seg * G, w), r1 = min(r0 + G, w);
    const uint64_t z = hash_segment<EDGE>(Q, K, P, b, r0, r1, w, nbp, d0,
                                          sh, mask, base, n);
    if (SPLIT) {
      uint64_t pre = z, suf = z;
      for (int d = 1; d < S; d <<= 1) {
        const uint64_t u = __shfl_up_sync(gmask, pre, d, S);
        const uint64_t v = __shfl_down_sync(gmask, suf, d, S);
        if (seg >= d) pre = min64(pre, u);
        if (seg + d < S) suf = min64(suf, v);
      }
      const uint64_t cp = __shfl_up_sync(gmask, pre, 1, S);
      cs = __shfl_down_sync(gmask, suf, 1, S);
      if (seg == S - 1) cs = BIG;
      if (seg > 0)
        for (int r = r0, a = r0 * nbp + b; r < r1; ++r, a += nbp)
          P[a] = min64(P[a], cp);
    }
  }
  return cs;
}

// SPLIT: a w-block's passes go to S > 1 lanes, each taking a segment of
// G slots; else S = 1 and G = w.
template <bool SPLIT>
__global__ void __launch_bounds__(BLOCK)
sketch_kernel(const uint8_t* __restrict__ codes, long long L, int k, int w,
              long long n, int blocks, int S, int G, uint32_t wmagic, bool aligned, uint32_t* __restrict__ out_h,
              int32_t* __restrict__ out_pos, uint8_t* __restrict__ out_strand,
              bool* __restrict__ out_emit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = blocks + 1;               // w-blocks: the halo, the tile's
  const int nbp = nb | 1;                  // odd: fewer bank conflicts
  if (!SPLIT) {
    S = 1;
    G = w;
  }
  uint64_t* K = reinterpret_cast<uint64_t*>(smem);   // [r][b], w x nbp
  uint64_t* P = K + (size_t)w * nbp;       // prefix minima, then windows'
  uint4* Q = reinterpret_cast<uint4*>(P + (size_t)w * nbp);
  const int t = threadIdx.x;
  const int T = blocks * w;                // positions a tile
  const long long tile0 = (long long)blockIdx.x * T;
  const long long base = tile0 - w;        // slot 0's position
  const long long cbase = base & ~15ll;    // Q[0]'s first code
  const int d0 = (int)(base - cbase);
  const int nw = (nb * w - 1 + k - 1 + d0) / 16 + 2;

  // the packed words (sketch_core::stage_words)
  sketch_core::stage_words(Q, codes, L, cbase, nw, aligned);
  __syncthreads();

  // Pass 1 (pass1 above)
  const int sh = 32 - 2 * k;
  const uint32_t mask = k == 16 ? 0xffffffffu : (1u << (2 * k)) - 1u;
  const int ls = SPLIT ? __ffs(S) - 1 : 0;
  const uint64_t cs =
      base < 0 || base + (long long)nb * w > n
          ? pass1<true, SPLIT>(Q, K, P, nb, S, ls, G, w, nbp, d0, sh, mask,
                               base, n)
          : pass1<false, SPLIT>(Q, K, P, nb, S, ls, G, w, nbp, d0, sh, mask,
                                base, n);
  __syncthreads();

  // Pass 2: block b's suffix minima, oldest slot last, each segment's
  // from cs; the window of slot (b + 1) w + r - 1 is [bw + r, (b + 1) w +
  // r - 1], the suffix of b from r and the prefix of b + 1 to r - 1. A
  // block's last slot keeps its prefix minimum, the whole block: its own
  // window.
  for (int it = t; it < (nb - 1) * S; it += BLOCK) {
    const int b = it >> ls, seg = it & (S - 1);
    const int r0 = max(min(seg * G, w), 1), r1 = min(seg * G + G, w);
    uint64_t sm = cs;
    int a = (r1 - 1) * nbp + b;
    for (int r = r1 - 1; r >= r0; --r) {
      sm = min64(sm, K[a]);
      uint64_t* pp = P + (a - nbp + 1);
      *pp = min64(sm, *pp);
      a -= nbp;
    }
  }
  __syncthreads();

  // Pass 3: four positions a thread, quads aligned to 4 positions (the
  // tile's first and last may be partial). Slot s is at [s % w][s / w]:
  // the slot before the quad's first (clamped to the tile's slots) by one
  // division, the next ones by steps. With wmagic the low word of
  // 2^32 / w + 1 (1 at w = 1, where the high word's s is added), s / w is
  // exact for s * w < 2^32.
  const int last = nb * w - 1;
  const long long end = tile0 + T < n ? tile0 + T : n;
  const long long quad0 = tile0 >> 2;
  const int nq = (int)(((end + 3) >> 2) - quad0);
  const int base32 = (int)base;            // positions fit 31 bits
  for (int u = t; u < nq; u += BLOCK) {
    const long long p = (quad0 + u) * 4;
    const int s0 = (int)(p - base);        // the quad's first slot
    const int sc = min(max(s0 - 1, w - 1), last);
    int b = (int)__umulhi((uint32_t)sc, wmagic) + (w == 1 ? sc : 0);
    int r = sc - b * w;
    uint64_t prev = P[r * nbp + b];
    uint32_t hv[4], strand = 0, emit = 0;
    int32_t pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + i;                       // slots before the
      if (s >= w && s <= last && ++r == w) {      // tile's stay at w - 1
        r = 0;
        ++b;
      }
      const uint64_t m = P[r * nbp + b];
      const uint32_t lo = (uint32_t)m;
      const uint32_t arg = TIE - (lo & TIE);      // the minimum's slot
      const bool self = arg == (uint32_t)(s0 + i);
      const bool same = (m ^ prev) >> 21 == 0;    // (mh, ml) as p - 1's
      hv[i] = (uint32_t)(m >> 32);
      pv[i] = base32 + (int)arg;
      strand |= ((lo >> 28) & 1u) << (8 * i);
      emit |= (uint32_t)(!same || self) << (8 * i);
      prev = m;
    }
    if (p >= tile0 && p + 4 <= end) {
      *reinterpret_cast<uint4*>(out_h + p) =
          make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<int4*>(out_pos + p) =
          make_int4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<uint32_t*>(out_strand + p) = strand;
      *reinterpret_cast<uint32_t*>(out_emit + p) = emit;
    } else {
      for (int i = 0; i < 4; ++i) {
        if (p + i < tile0 || p + i >= end) continue;
        out_h[p + i] = hv[i];
        out_pos[p + i] = pv[i];
        out_strand[p + i] = (uint8_t)(strand >> (8 * i));
        out_emit[p + i] = (bool)((emit >> (8 * i)) & 1u);
      }
    }
  }
}

}  // namespace

// codes: (L,) bytes (taken & 3); blocks, segs and seg_len: the tile's
// w-blocks, the lanes a w-block's passes take and the slots of a lane's
// segment, chosen by index/cuda_sketch.py (tile_blocks, segments,
// segment_len); h, pos, strand, emit: (L - k + 1,)
// uint32 (the wrapper's int32 bits), int32, uint8 and bool outputs, each
// 16-byte aligned (fresh allocations)
extern "C" int sketch_launch(const void* codes, long long L, int k, int w,
                             int blocks, int segs, int seg_len, void* h, void* pos, void* strand, void* emit,
                             void* stream) {
  const long long n = L - k + 1;
  // blocks >= 2, s / w by wmagic exact for every slot s of a tile, segs a
  // power of 2 up to 32 that gives each segment a lane where > 1, and
  // the segments covering a w-block
  if (k < 1 || k > 16 || w < 1 || w > MAX_W || L < 0 ||
      n >= (1ll << 31) || blocks < 2 ||
      (long long)(blocks + 1) * w * w >= (1ll << 32) || segs < 1 ||
      segs > 32 || (segs & (segs - 1)) ||
      (segs > 1 && (blocks + 1) * segs > BLOCK) || seg_len < 1 ||
      (long long)segs * seg_len < w || (segs == 1 && seg_len != w))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(k, w, blocks);
  // above 48 KB a block's dynamic shared memory needs the attribute, set
  // once a device to the most a block may have
  static int most[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!most[dev]) {
    int m = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &m, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sketch_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, m);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sketch_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, m);
    if (e != cudaSuccess) return (int)e;
    most[dev] = m;
  }
  if (smem > (size_t)most[dev]) return (int)cudaErrorInvalidValue;
  const long long T = (long long)blocks * w;
  const unsigned grid = (unsigned)((n + T - 1) / T);
  const uint32_t wmagic = (uint32_t)(0x100000000ull / (unsigned)w + 1);
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  auto kernel = segs > 1 ? sketch_kernel<true> : sketch_kernel<false>;
  kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), L, k, w, n, blocks, segs, seg_len,
      wmagic, aligned, static_cast<uint32_t*>(h),
      static_cast<int32_t*>(pos), static_cast<uint8_t*>(strand),
      static_cast<bool*>(emit));
  return (int)cudaGetLastError();
}
