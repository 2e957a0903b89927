// The per-lane bi-interval ladder of the k-mer tables, run by
// kmer_table.cu's kmer_freq_scan from the interval-table pyramid's level
// and by planes.cu (kmer_table_full runs its own step loop, both strands
// in one round of loads; the wire kernel steps a compacted list of lanes,
// lane_list.cuh, with the state and the rank of this file).
//
// Replaces the level loop that the JAX package's ops/scan.py writes out in
// each of kmer_freq_scan (:49-61), kmer_table_full (:124-139) and
// kmer_table_planes (:305-319).
//
// Lane (r, p) holds the bi-interval of reads[r, p : p+j] after step j: the
// fwd interval on the RBWT and the reverse-complement interval on the BWT.
// Step j appends the character at p + j; a lane whose window left the row
// (PAD_RANK or past L) keeps its state, and its snapshots are fake anyway.
// A strand whose interval became invalid (lo > hi) stays invalid with size
// 0 under the LF math, so its rank queries are skipped: the snapshots are
// those of the JAX ladder, which keeps updating it.
//
// The rank is a template argument: BlockRank counts in the 128-symbol rows
// of rank.cuh, planes.cuh's PlaneRank in bit-plane rows.
#pragma once

#include <cstdint>

#include "rank.cuh"

namespace lrsc {

struct BiInterval {
  int f_lo, f_hi, r_lo, r_hi;

  // getFreq of both strands (BWTInterval.h:27-29)
  __device__ __forceinline__ int size() const {
    return max(f_hi - f_lo + 1, 0) + max(r_hi - r_lo + 1, 0);
  }
  // BiBWTInterval::isValid: both strands valid (BWTInterval.h:84)
  __device__ __forceinline__ bool valid() const {
    return f_lo <= f_hi && r_lo <= r_hi;
  }
};

// One BWT in the 128-symbol block layout (index/pack.py).
struct BlockRank {
  const int8_t* __restrict__ blocks;
  const int* __restrict__ ckpt;
  const int* __restrict__ C;
  int nb;

  __device__ __forceinline__ void update(int sym, int& lo, int& hi) const {
    update_interval(blocks, ckpt, C, nb, sym, lo, hi);
  }
  // The same step by rank.cuh update_interval_shared's rule (one row for
  // both ends where they share a block, every load issued before any
  // count; the same values), for lane_list.cuh: each vector is counted as
  // a value, where update_interval_shared's choice between two arrays'
  // elements puts them on the stack (256 bytes a thread, ptxas).  live =
  // false leaves [lo, hi] as it is.
  __device__ __forceinline__ void update_shared(int sym, int& lo, int& hi, bool live) const {
    const int pa = lo, pb = hi + 1;  // prefix lengths of the two ends
    const int qa = pa >> 7, qb = pb >> 7;
    const int ra = pa - (qa << 7), rb = pb - (qb << 7);
    const bool same = qa == qb;
    const int ia = min(max(qa, 0), nb - 1), ib = min(max(qb, 0), nb - 1);
    const uint4* rowa = reinterpret_cast<const uint4*>(blocks + (size_t)ia * kBlock);
    const uint4* rowb = reinterpret_cast<const uint4*>(blocks + (size_t)ib * kBlock);
    const int needa = !live ? 0 : same ? max(ra, rb) : ra;  // symbols read from row a
    const int needb = !live || same ? 0 : rb;               // and from row b
    const int pc = live ? __ldg(C + sym) : 0;
    const int cka = live ? __ldg(ckpt + (size_t)ia * 5 + sym) : 0;
    const int ckb = live && !same ? __ldg(ckpt + (size_t)ib * 5 + sym) : cka;
    const unsigned pat = 0x01010101u * (unsigned)sym;
    int ca = 0, cb = 0;
#pragma unroll
    for (int v = 0; v < kBlock / 16; ++v) {
      const uint4 a = needa > 16 * v ? __ldg(rowa + v) : make_uint4(0u, 0u, 0u, 0u);
      // end b counts row a's vector where it shares the row (needb = 0),
      // and nothing where it has no symbol in this vector
      const uint4 b = needb > 16 * v ? __ldg(rowb + v) : a;
      ca += count_vec(a, pat, ra - 16 * v);
      cb += count_vec(b, pat, rb - 16 * v);
    }
    if (live) {
      lo = pc + cka + ca;
      hi = pc + ckb + cb - 1;
    }
  }
};

// The interval of the one-character word s0 (init_bi).
template <class Rank>
__device__ __forceinline__ BiInterval init_bi(const Rank& fwd, const Rank& rev, int s0) {
  const int c0 = comp(s0);
  return BiInterval{__ldg(fwd.C + s0), __ldg(fwd.C + s0 + 1) - 1, __ldg(rev.C + c0),
                    __ldg(rev.C + c0 + 1) - 1};
}

// Walks j = j0..j1 from st, the lane's state at level j0, calling
// emit(j, fake, state) at each level (fake: the window p..p+j-1 runs past
// the read's len).  row is the lane's read, L its padded width.
template <class Rank, class Emit>
__device__ __forceinline__ void ladder(const Rank& fwd, const Rank& rev,
                                       const int8_t* __restrict__ row, int p, int L,
                                       int len, int j0, int j1, BiInterval st,
                                       Emit&& emit) {
  for (int j = j0; j <= j1; ++j) {
    emit(j, p + j > len, st);
    if (j == j1) break;
    const int nxt = p + j < L ? (int)row[p + j] : kPadRank;
    if (nxt >= kPadRank) continue;  // past the read: state frozen
    const int s = max(nxt, 0);
    if (st.f_lo <= st.f_hi) fwd.update(s, st.f_lo, st.f_hi);
    if (st.r_lo <= st.r_hi) rev.update(comp(s), st.r_lo, st.r_hi);
  }
}

}  // namespace lrsc
