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

// #bytes equal to `pat`'s among the first `rem` bytes of the 16 in w, with
// no branch (rem <= 0 counts none)
__device__ __forceinline__ int count_vec(const uint4& w, unsigned pat, int rem) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  int n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = rem - 4 * k;
    const unsigned keep = r >= 4 ? ~0u : r <= 0 ? 0u : (1u << (8 * r)) - 1u;
    n += __popc(__vcmpeq4(words[k], pat) & keep);
  }
  return n >> 3;  // eight bits per equal byte
}

// update_interval's step, with one row load for both ends where it can:
// when BWT[0..lo-1] and BWT[0..hi] end in one block (lo >> 7 == (hi+1) >> 7,
// as nearly always once an interval holds a few dozen suffixes), its row
// and checkpoint word are read once and both prefixes counted from them;
// otherwise each end reads its own.  live = false loads nothing and leaves
// [lo, hi] as it is.  Every load is predicated and issued before any count,
// so a step costs one round of loads (occ's guarded loop can wait for each
// 16-byte vector in turn), and the steps of two strands can be in flight
// together.  The same values as update_interval.
//
// Debt: ladder.cuh's BlockRank::update_shared is the same rule with each
// vector counted as a value, where this one keeps its 16 vectors on a
// 256-byte stack; on kmer_table_full it ran 0.42 -> 0.36-0.38 ms, exact
// (PERF.md §6, tools/prof_tables.py full-regstep).  It is to replace this
// function in kmer_table_full and walk.cuh's prep_task, which is then
// deleted (ROADMAP.md Queue 2 item 5).
__device__ __forceinline__ void update_interval_shared(const int8_t* __restrict__ blocks,
                                                       const int* __restrict__ ckpt,
                                                       const int* __restrict__ C, int nb,
                                                       int sym, int& lo, int& hi,
                                                       bool live = true) {
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
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 wa[kBlock / 16], wb[kBlock / 16];
#pragma unroll
  for (int v = 0; v < kBlock / 16; ++v) {
    wa[v] = needa > 16 * v ? __ldg(rowa + v) : zero;
    wb[v] = needb > 16 * v ? __ldg(rowb + v) : zero;
  }
  const unsigned pat = 0x01010101u * (unsigned)sym;
  int ca = 0, cb = 0;
#pragma unroll
  for (int v = 0; v < kBlock / 16; ++v) {
    ca += count_vec(wa[v], pat, ra - 16 * v);
    cb += count_vec(same ? wa[v] : wb[v], pat, rb - 16 * v);
  }
  if (live) {
    lo = pc + cka + ca;
    hi = pc + ckb + cb - 1;
  }
}

// 0x01 in each byte of w that holds symbol 1, 2, 3 or 4 (f[0..3]).  The
// index bytes are symbols 0..5 (5 pads the last block), so the low three
// bits tell them apart: 1 = 001, 2 = 010, 3 = 011, 4 = 100 (0 and 5 = 101
// match none).
__device__ __forceinline__ void acgt_flags(unsigned w, unsigned (&f)[4]) {
  const unsigned b0 = w & 0x01010101u, b1 = (w >> 1) & 0x01010101u,
                 b2 = (w >> 2) & 0x01010101u;
  f[0] = b0 & ~(b1 | b2);
  f[1] = b1 & ~(b0 | b2);
  f[2] = b0 & b1 & ~b2;
  f[3] = b2 & ~(b0 | b1);
}

// M-form mask (0x01 in each kept byte) of word j's bytes below byte r of
// a 64-byte half row (0 <= r < 64): whole words below r, the partial word
// r >> 2, none above
__device__ __forceinline__ unsigned half_prefix_mask(int j, int r) {
  const unsigned part = (unsigned)((1ull << (8 * (r & 3))) - 1ull) & 0x01010101u;
  return j < (r >> 2) ? 0x01010101u : j == (r >> 2) ? part : 0u;
}

// occ of all four ACGT symbols at both ends of an interval, the JAX
// occ_all (ops/rank.py:43) at lo - 1 and hi: a[c] = occ(c + 1, lo - 1),
// b[c] = occ(c + 1, hi), the same values as occ.  An end whose prefix
// ends in the first half of its row (r < 64 symbols) counts that prefix
// from the row's first 64 bytes and adds it to the row's checkpoint; one
// that ends in the second half counts the rest of the row, from r on,
// and takes it from the next row's checkpoint (after the last row, the
// symbol's total C[c + 1] - C[c]: the pack pads the last row with
// symbol 5).  So an end reads one 64-byte half row and counts at most 16
// words; both ends read one half where they share it.  Per word the four
// symbols' byte flags are added in byte lanes (at most 16 a lane) under
// the end's byte mask.
__device__ __forceinline__ void occ_acgt_pair(const int8_t* __restrict__ blocks,
                                              const int* __restrict__ ckpt,
                                              const int* __restrict__ C, int nb, int lo,
                                              int hi, int (&a)[4], int (&b)[4]) {
  const int pa = lo, pb = hi + 1;  // prefix lengths of the two ends
  const int qa = pa >> 7, qb = pb >> 7;
  const int ra = pa - (qa << 7), rb = pb - (qb << 7);
  const int ia = min(max(qa, 0), nb - 1), ib = min(max(qb, 0), nb - 1);
  // the half each end counts (a clamped row counts its prefix)
  const int ha = ra >= 64 && qa == ia, hb = rb >= 64 && qb == ib;
  const bool share = ia == ib && ha == hb;
  const uint4* va = reinterpret_cast<const uint4*>(blocks + (size_t)ia * kBlock) + 4 * ha;
  const uint4* vb = reinterpret_cast<const uint4*>(blocks + (size_t)ib * kBlock) + 4 * hb;
  uint4 xa[4], xb[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    xa[v] = __ldg(va + v);
    xb[v] = share ? xa[v] : __ldg(vb + v);
  }
  // the checkpoint row each end adds to (its row) or takes from (the next)
  const int ka = ia + ha, kb = ib + hb;
  const int* cpa = ckpt + (size_t)min(ka, nb - 1) * 5;
  const int* cpb = ckpt + (size_t)min(kb, nb - 1) * 5;
  int ca[4], cb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int total = __ldg(C + c + 2) - __ldg(C + c + 1);
    ca[c] = ka < nb ? __ldg(cpa + c + 1) : total;
    cb[c] = kb < nb ? __ldg(cpb + c + 1) : total;
  }
  const int ra2 = ra - 64 * ha, rb2 = rb - 64 * hb;  // bytes into the half
  const unsigned fa = ha ? 0x01010101u : 0u, fb = hb ? 0x01010101u : 0u;
  unsigned sa[4] = {0u, 0u, 0u, 0u}, sb[4] = {0u, 0u, 0u, 0u}, f[4], g[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const unsigned wa[4] = {xa[v].x, xa[v].y, xa[v].z, xa[v].w};
    const unsigned wb[4] = {xb[v].x, xb[v].y, xb[v].z, xb[v].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // a prefix keeps the bytes below r, a suffix the others
      const unsigned ma = half_prefix_mask(4 * v + k, ra2) ^ fa;
      const unsigned mb = half_prefix_mask(4 * v + k, rb2) ^ fb;
      acgt_flags(wa[k], f);
      acgt_flags(wb[k], g);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[c] += f[c] & ma;
        sb[c] += g[c] & mb;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int na = (int)((sa[c] * 0x01010101u) >> 24), nb2 = (int)((sb[c] * 0x01010101u) >> 24);
    a[c] = ha ? ca[c] - na : ca[c] + na;
    b[c] = hb ? cb[c] - nb2 : cb[c] + nb2;
  }
}

__device__ __forceinline__ int comp(int sym) { return sym == 0 ? 0 : 5 - sym; }

}  // namespace lrsc
