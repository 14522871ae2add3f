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
// What bounds it on this card: the function needs ~72 32-bit integer
// operations a position (a rolling k-mer, eight table steps of the CRC,
// an amortized sliding minimum; chip_smoke.SKETCH_OPS counts them) at
// the INT32 rate, half the float32 one, against 11 bytes of traffic (a
// code read, 10 bytes of outputs): the integer rate bounds it, not HBM.
// This kernel does more, ~150 at k = 15, w = 10 (below). The design
// keeps every operand of those operations in shared memory:
// - A block takes TILE = 1024 positions. It stages their codes, with a
//   halo of w positions before the tile (the window of its first
//   position and of the position before it, which the emission rule
//   needs) and k - 1 after, once in shared memory, and builds the 256-word
//   CRC table there (each thread one entry, eight shift-xor steps).
// - Each thread hashes tile and halo positions from the staged codes
//   into shared (h, lo) words; after one barrier each thread scans the w
//   words of its own positions' windows (neighbouring threads read
//   neighbouring words: no bank conflicts) and keeps their minima in
//   registers; after another barrier it compares them with the minimum
//   of the position before, which the previous thread (or, at the
//   tile's first position, thread 0's scan of the halo) wrote.
// - Outputs are written with neighbouring threads on neighbouring
//   positions. A simple kernel first: the k-mer is rebuilt from k codes
//   and the window rescanned at every position (an incremental k-mer and
//   a sliding minimum would cut the operations, a later change).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;             // threads a block
constexpr int TILE = 1024;             // positions a block
constexpr int PER = TILE / BLOCK;      // positions a thread
constexpr int MAX_W = 1024;
constexpr uint32_t BIG = 0xffffffffu;
constexpr uint32_t CRC_POLY = 0x82f63b78u;   // CRC32-C, reflected

// _mm_crc32_u64(kx, kx) for kx < 2^32: the accumulator starts at kx and
// takes the 8 bytes of kx LSB first, the last four zero
__device__ __forceinline__ uint32_t hash_of(uint32_t kx,
                                            const uint32_t* tab) {
  uint32_t r = kx;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r = (r >> 8) ^ tab[(r ^ (kx >> (8 * i))) & 0xffu];
#pragma unroll
  for (int i = 0; i < 4; ++i) r = (r >> 8) ^ tab[r & 0xffu];
  return r;
}

__global__ void __launch_bounds__(BLOCK)
sketch_kernel(const uint8_t* __restrict__ codes, long long L, int k, int w,
              long long n, uint32_t* __restrict__ out_h,
              int32_t* __restrict__ out_pos, uint8_t* __restrict__ out_strand,
              bool* __restrict__ out_emit) {
  extern __shared__ uint32_t smem[];
  const int nh = TILE + w;                       // (h, lo) slots
  uint32_t* tab = smem;                          // 256
  uint32_t* H = tab + 256;                       // nh
  uint32_t* LO = H + nh;                         // nh
  uint32_t* MH = LO + nh;                        // TILE + 1
  uint32_t* ML = MH + TILE + 1;                  // TILE + 1
  uint8_t* C = reinterpret_cast<uint8_t*>(ML + TILE + 1);   // nh + k - 1
  const int t = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * TILE;
  const long long base = tile0 - w;              // slot 0's position

  {
    uint32_t c = t;
#pragma unroll
    for (int i = 0; i < 8; ++i) c = (c >> 1) ^ ((c & 1u) ? CRC_POLY : 0u);
    tab[t] = c;
  }
  for (int j = t; j < nh + k - 1; j += BLOCK) {
    const long long q = base + j;
    C[j] = (q >= 0 && q < L) ? (codes[q] & 3) : 0;
  }
  __syncthreads();

  const uint32_t mask = k == 16 ? BIG : (1u << (2 * k)) - 1u;
  for (int j = t; j < nh; j += BLOCK) {
    const long long q = base + j;
    uint32_t h = BIG, lo = BIG;
    if (q >= 0 && q < n) {
      uint32_t k0 = 0, k1 = 0;
      for (int i = 0; i < k; ++i) {
        const uint32_t c = C[j + i];
        k0 |= c << (2 * (k - 1 - i));
        k1 |= (3u ^ c) << (2 * i);
      }
      const bool strand = k1 <= k0;
      const uint32_t km = strand ? k1 : k0;
      const uint32_t kx = strand ? k0 : k1;
      h = (hash_of(kx, tab) ^ km) & mask;
      lo = ((uint32_t)q % (uint32_t)w) | ((uint32_t)strand << 7);
    }
    H[j] = h;
    LO[j] = lo;
  }
  __syncthreads();

  // the window minimum of slot j (position base + j), folded oldest to
  // newest, the newer taking full ties; slots before position 0 hold
  // (BIG, BIG)
  auto scan = [&](int j, uint32_t& mh, uint32_t& ml, int& d_at) {
    mh = BIG;
    ml = BIG;
    d_at = 0;
    for (int d = w - 1; d >= 0; --d) {
      const uint32_t sh = H[j - d], sl = LO[j - d];
      if (sh < mh || (sh == mh && sl <= ml)) {
        mh = sh;
        ml = sl;
        d_at = d;
      }
    }
  };
  uint32_t mh[PER], ml[PER];
  int d_at[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = t + r * BLOCK;
    if (tile0 + i < n) {
      scan(w + i, mh[r], ml[r], d_at[r]);
      MH[i + 1] = mh[r];
      ML[i + 1] = ml[r];
    }
  }
  if (t == 0 && tile0 > 0) {           // the position before the tile
    int d;
    scan(w - 1, MH[0], ML[0], d);
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = t + r * BLOCK;
    const long long p = tile0 + i;
    if (p >= n) break;
    const bool same_prev = p > 0 && MH[i] == mh[r] && ML[i] == ml[r];
    const bool is_self = mh[r] == H[w + i] && ml[r] == LO[w + i];
    out_h[p] = mh[r];
    out_pos[p] = (int32_t)(is_self ? p : p - d_at[r]);
    out_strand[p] = (uint8_t)((ml[r] >> 7) & 1u);
    out_emit[p] = !same_prev || is_self;
  }
}

}  // namespace

// codes: (L,) bytes (taken & 3); h, pos, strand, emit: (L - k + 1,)
// uint32 (the wrapper's int32 bits), int32, uint8 and bool outputs
extern "C" int sketch_launch(const void* codes, long long L, int k, int w,
                             void* h, void* pos, void* strand, void* emit,
                             void* stream) {
  const long long n = L - k + 1;
  if (k < 1 || k > 16 || w < 1 || w > MAX_W || L < 0 ||
      n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const int nh = TILE + w;
  const size_t smem = (256 + 2 * (size_t)nh + 2 * (TILE + 1)) *
                          sizeof(uint32_t) + nh + k - 1;
  const unsigned grid = (unsigned)((n + TILE - 1) / TILE);
  sketch_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), L, k, w, n,
      static_cast<uint32_t*>(h), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(strand), static_cast<bool*>(emit));
  return (int)cudaGetLastError();
}
