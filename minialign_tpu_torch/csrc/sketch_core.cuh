// The (w,k)-minimizer sketch's shared steps on the card, for the device
// sketch S1 (sketch.cu) and the batch seed pass S2 (seed.cu): codes
// packed 16 to a 32-bit word beside each word's reverse complement, so
// that a k-mer and its reverse complement are two funnel shifts, with no
// loop over k; and the 64-bit minimum of the sliding-window passes.
#pragma once

#include <cstdint>

namespace sketch_core {

// four bytes (the first at the lowest address) as four 2-bit codes, the
// first in the top bits of the result's low byte
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  x = __byte_perm(x & 0x03030303u, 0, 0x0123);   // first code at byte 3
  x |= x >> 6;
  x |= x >> 12;
  return x & 0xffu;
}

// 16 codes from position q0 on, packed first code in the top bits;
// codes outside [0, L) count as 0. aligned: codes + q0 is 16-byte
// aligned, so that a word whose 16 codes lie in [0, L) is one 16-byte
// load
__device__ __forceinline__ uint32_t pack16(const uint8_t* __restrict__ codes,
                                           long long L, long long q0,
                                           bool aligned) {
  if (aligned && q0 >= 0 && q0 + 16 <= L) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + q0));
    return pack4(v.x) << 24 | pack4(v.y) << 16 | pack4(v.z) << 8 |
           pack4(v.w);
  }
  uint32_t r = 0;
  for (int j = 0; j < 16; ++j) {
    const long long q = q0 + j;
    const uint32_t c = (q >= 0 && q < L) ? (codes[q] & 3u) : 0u;
    r |= c << (30 - 2 * j);
  }
  return r;
}

// the complemented codes in reverse order, first code in the low bits:
// the bit-reversed word has each code's two bits swapped; swap them back
__device__ __forceinline__ uint32_t revcomp(uint32_t wd) {
  const uint32_t y = __brev(wd);
  return ~(((y & 0x55555555u) << 1) | ((y >> 1) & 0x55555555u));
}

__device__ __forceinline__ uint64_t min64(uint64_t a, uint64_t b) {
  return b < a ? b : a;
}

// Q[i] = (W[i], W[i + 1], R[i], R[i + 1]) for i in [0, nw): W[i] the 16
// codes of codes[0, L) from q0 + 16 i on (pack16; aligned: each codes +
// q0 + 16 i is 16-byte aligned), R[i] its revcomp.
// Lane l of a warp packs word i0 + l; lanes 0-30 store Q[i] with the next
// lane's word beside their own. Every thread of the block calls it.
__device__ __forceinline__ void stage_words(uint4* __restrict__ Q,
                                            const uint8_t* __restrict__ codes,
                                            long long L, long long q0, int nw,
                                            bool aligned) {
  const int lane = threadIdx.x & 31;
  const int step = (blockDim.x >> 5) * 31;
  for (int i0 = (threadIdx.x >> 5) * 31; i0 < nw; i0 += step) {
    const int i = i0 + lane;
    const uint32_t wd = pack16(codes, L, q0 + 16ll * i, aligned);
    const uint32_t rc = revcomp(wd);
    const uint32_t wn = __shfl_down_sync(0xffffffffu, wd, 1);
    const uint32_t rn = __shfl_down_sync(0xffffffffu, rc, 1);
    if (lane < 31 && i < nw) Q[i] = make_uint4(wd, wn, rc, rn);
  }
}

// The k-mer at code off of Q's words (off >> 4 < nw - 1) and its reverse
// complement: k0 with its first code in the top bits, k1 = the
// complements in reverse order (k1 |= (3 ^ c_j) << 2j); sh = 32 - 2k,
// mask = 4^k - 1.
__device__ __forceinline__ void kmer_pair(const uint4* __restrict__ Q,
                                          int off, int sh, uint32_t mask,
                                          uint32_t* k0, uint32_t* k1) {
  const uint4 v = Q[off >> 4];             // W[i], W[i+1], R[i], R[i+1]
  const int s = (off & 15) * 2;
  *k0 = __funnelshift_l(v.y, v.x, s) >> sh;
  *k1 = __funnelshift_r(v.z, v.w, s) & mask;
}

}  // namespace sketch_core
