// Block rank over the packed FM-index layout, shared by the kernels.
//
// Replaces the rank primitive of the JAX package (ops/rank.py:31 occ,
// :68 update_interval, :117 extend_bi), which XLA inlined into every
// kernel; here it is a __device__ function and never launched alone.
//
// Layout (index/pack.py): blocks int8 [nb, 128] of BWT symbols padded with
// PAD_RANK, ckpt int32 [nb, 5] = per-symbol counts before each block,
// C int32 [6].  occ(s, idx) = ckpt[q][s] + #s in blocks[q][0:r] with
// p = idx + 1, q = p / 128, r = p % 128; idx = -1 gives p = 0 -> 0.
//
// Bound on the H100: one random 128-byte row (4 sectors of 32 bytes, one
// L2 line) plus one 4-byte checkpoint word per query, in an index far
// larger than the 50 MB L2.  Only the 16-byte vectors that hold the first
// r symbols are loaded, so a query reads 1-8 vectors (r/16 rounded up);
// each vector is compared four bytes at a time (__vcmpeq4) and popcounted.
#pragma once

#include <cstdint>

namespace lrsc {

constexpr int kBlock = 128;
constexpr int kPadRank = 5;

// #bytes equal to `pat`'s byte among the first `rem` bytes of word w
// (little-endian: byte 0 is the earliest symbol).
__device__ __forceinline__ int count_word(unsigned w, unsigned pat, int rem) {
  if (rem <= 0) return 0;
  unsigned eq = __vcmpeq4(w, pat);  // 0xFF in every equal byte
  if (rem < 4) eq &= (1u << (8 * rem)) - 1u;
  return __popc(eq) >> 3;
}

// #occurrences of sym (0..4) in BWT[0..idx]; idx >= -1.  The row index is
// clamped into the table as the JAX gather clamps it (never reached for
// intervals produced by the LF math, whose ends stay in [-1, n]).
__device__ __forceinline__ int occ(const int8_t* __restrict__ blocks,
                                   const int* __restrict__ ckpt, int nb,
                                   int sym, int idx) {
  int p = idx + 1;
  int q = p >> 7;
  int r = p - (q << 7);
  q = min(max(q, 0), nb - 1);
  const uint4* row = reinterpret_cast<const uint4*>(blocks + (size_t)q * kBlock);
  const unsigned pat = 0x01010101u * (unsigned)sym;
  int cnt = 0;
#pragma unroll
  for (int v = 0; v < kBlock / 16; ++v) {
    const int rem = r - 16 * v;
    if (rem > 0) {
      const uint4 w = __ldg(row + v);
      cnt += count_word(w.x, pat, rem) + count_word(w.y, pat, rem - 4) +
             count_word(w.z, pat, rem - 8) + count_word(w.w, pat, rem - 12);
    }
  }
  return __ldg(ckpt + (size_t)q * 5 + sym) + cnt;
}

// One LF step of an interval over one BWT: [lo, hi] of S -> of (sym)S.
__device__ __forceinline__ void update_interval(const int8_t* __restrict__ blocks,
                                                const int* __restrict__ ckpt,
                                                const int* __restrict__ C, int nb,
                                                int sym, int& lo, int& hi) {
  const int pb = __ldg(C + sym);
  const int nlo = pb + occ(blocks, ckpt, nb, sym, lo - 1);
  const int nhi = pb + occ(blocks, ckpt, nb, sym, hi) - 1;
  lo = nlo;
  hi = nhi;
}

__device__ __forceinline__ int comp(int sym) { return sym == 0 ? 0 : 5 - sym; }

}  // namespace lrsc
