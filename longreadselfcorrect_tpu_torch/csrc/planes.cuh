// Block rank over bit-plane rows, for the kmer_table_planes kernel.
//
// Replaces the JAX package's ops/scan.py:243 _occ_planes and :270
// _update_planes (XLA inlined them into kmer_table_planes); here they are
// __device__ functions and never launched alone.
//
// Layout (ops/scan.py:212 _build_plane_rows): one int32 row [17] per
// 128-symbol block: 3 bit-planes of 4 words (bit j of word w of plane i =
// bit i of symbol 32w + j), then the block's 5 checkpoint counts.
// occ(s, idx) = ckpt[s] + popc over the words below r of the positions
// whose three bits equal s's, with p = idx + 1, q = p / 128, r = p % 128.
//
// Bound on the H100: one random 68-byte row per query (three 32-byte
// sectors at most), against 128 + 4 bytes for the symbol rows of rank.cuh.
// Only the words below r are loaded; the masks are unsigned, so the 31-bit
// mask needs no int32 wraparound.
#pragma once

#include <cstdint>

#include "rank.cuh"

namespace lrsc {

constexpr int kPlaneWords = kBlock / 32;        // 4 words per plane
constexpr int kPlaneRow = 3 * kPlaneWords + 5;  // 17 ints

struct PlaneRank {
  const int* __restrict__ prows;  // [nb, kPlaneRow]
  const int* __restrict__ C;
  int nb;

  // #occurrences of sym (0..4) in BWT[0..idx]; idx >= -1.  The row index
  // is clamped into the table as the JAX gather clamps it.
  __device__ __forceinline__ int occ(int sym, int idx) const {
    const int p = idx + 1;
    int q = p >> 7;
    const int r = p - (q << 7);
    q = min(max(q, 0), nb - 1);
    const int* row = prows + (size_t)q * kPlaneRow;
    const unsigned e0 = 0u - (unsigned)(sym & 1);
    const unsigned e1 = 0u - (unsigned)((sym >> 1) & 1);
    const unsigned e2 = 0u - (unsigned)((sym >> 2) & 1);
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < kPlaneWords; ++w) {
      const int k = r - 32 * w;
      if (k > 0) {
        const unsigned mask = k >= 32 ? ~0u : (1u << k) - 1u;
        const unsigned match = ~(((unsigned)__ldg(row + w) ^ e0) |
                                 ((unsigned)__ldg(row + kPlaneWords + w) ^ e1) |
                                 ((unsigned)__ldg(row + 2 * kPlaneWords + w) ^ e2));
        cnt += __popc(match & mask);
      }
    }
    return __ldg(row + 3 * kPlaneWords + sym) + cnt;
  }

  // One LF step of an interval: [lo, hi] of S -> of (sym)S.
  __device__ __forceinline__ void update(int sym, int& lo, int& hi) const {
    const int pb = __ldg(C + sym);
    const int nlo = pb + occ(sym, lo - 1);
    const int nhi = pb + occ(sym, hi) - 1;
    lo = nlo;
    hi = nhi;
  }
};

}  // namespace lrsc
