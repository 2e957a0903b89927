// The k-mer tables of the seed phase: for every (read, pos) lane, the
// both-strand frequency (and validity) of the k-mer reads[pos : pos+k],
// from one bi-interval LF ladder per lane (ladder.cuh).
//
// Replaces, from the JAX package's ops/scan.py:
//   kmer_table_full (:108, with its fused-row occ :83 / :102): freq int32 and
//     valid bool for every k in 0..max_k;
//   kmer_table_wire (:143): the same table as int16 freq clipped at 32767
//     and valid packed 8 k-levels per byte (bit b of byte g = row 8g + b);
//   kmer_freq_scan (:32): int32 freq for each k of an ascending pool only.
//
// Bound on the H100: random reads into the index.  Each live step of a
// lane extends the fwd interval on the RBWT and the rvc interval on the
// BWT: four rank queries, each one 128-byte symbol row plus one checkpoint
// word, into two ~140 MB tables at the bench scale, which the 50 MB L2
// cannot hold.  Then the table writes: (max_k + 1) * R * L * 5 bytes for
// the full table, * 2.125 for the wire table, len(pool) * R * L * 4 for
// the pool.
//
// Design: kmer_table_full and kmer_freq_scan run one thread per lane, its
// four interval ends in registers, k = 1..max_k, so the only memory
// traffic is the rank rows and the coalesced table writes (consecutive
// threads = consecutive positions).  Blocks and checkpoints stay two
// arrays, not one fused row as on the TPU: the TPU fused them to save a
// gather per query, while here a query reads the checkpoint word as one
// extra 32-byte sector either way, and a fused copy would double the
// index's device memory.  Row 0 is the JAX table's constant level 0 (freq
// -1, valid false).
//
// All three start each lane from the interval-table pyramid of the walk
// index (ops/walk.py get_tables: the interval of every j-mer for j =
// 1..ck, ck = 12 at the bench scale): where reads[pos : pos+c] is ACGT,
// level j <= c is one independent 16-byte load keyed by the j-mer's 2-bit
// code, so the ladder's first c - 1 dependent LF steps (four rank queries
// each) are gone.  From level c on kmer_table_full runs the ladder, both
// strands' steps in one round of loads, one index row for both ends where
// they share a block (rank.cuh update_interval_shared).  Those levels,
// where a surviving lane's rows are its own, take most of the time
// (PERF.md).  kmer_freq_scan loads only its pool's levels up to c, steps no
// level past the pool's top or the read's end, and runs ladder.cuh's step.
// The wire kernel steps the levels past c on lane_list.cuh's compacted
// list of live lanes, whole warps of them, and clips and packs in the
// owners' registers: no int32 table exists in between.  Without a pyramid
// (ck = 0) every lane starts at level 1.
#include <cuda_runtime.h>

#include <cstdint>

#include "ladder.cuh"
#include "lane_list.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPool = 16;

struct Pool {
  int n;
  int k[kMaxPool];
};

struct Lane {
  size_t id;  // r * L + p
  int p, len;
  const int8_t* row;
  lrsc::BiInterval st;
};

// The lane of this thread, or false past the last lane.
__device__ __forceinline__ bool lane_of(const lrsc::BlockRank& fwd,
                                        const lrsc::BlockRank& rev,
                                        const int8_t* __restrict__ reads,
                                        const int* __restrict__ lens, int R, int L,
                                        Lane& out) {
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)R * L) return false;
  const int r = (int)(lane / L);
  out.id = lane;
  out.p = (int)(lane - (size_t)r * L);
  out.row = reads + (size_t)r * L;
  out.len = lens[r];
  out.st = lrsc::init_bi(fwd, rev, min(max((int)out.row[out.p], 0), 4));
  return true;
}

// Levels 1..ck of the interval table of every j-mer (f_lo, f_hi, r_lo,
// r_hi; code of a word = its symbols - 1 left to right, 2 bits each): the
// levels below ck concatenated in `lower` (level j from row (4^j - 4) / 3),
// level ck in `top`.  ck = 0: no table.
struct Pyramid {
  const int4* __restrict__ lower;
  const int4* __restrict__ top;
  int ck;
};
constexpr int kMaxPyramid = 12;  // 4^12 x 16 B = 268 MB at the top level

__device__ __forceinline__ const int4* level_row(const Pyramid& pyr, int j, unsigned code) {
  return j < pyr.ck ? pyr.lower + (((1u << (2 * j)) - 4u) / 3u) + code : pyr.top + code;
}

// The lane's clean prefix: the leading symbols in 1..4 of sym[0..n) (its
// symbols from p on, n at most the row's rest); code: their 2-bit code.
__device__ __forceinline__ int clean_prefix(const int8_t* __restrict__ sym, int n,
                                            unsigned& code) {
  int c = 0;
  code = 0;
  for (; c < n; ++c) {
    const int s = sym[c];
    if (s < 1 || s > 4) break;
    code = (code << 2) | (unsigned)(s - 1);
  }
  return c;
}

// The interval of the lane's first j symbols, j <= c (its clean prefix of
// that code): one pyramid load.
__device__ __forceinline__ lrsc::BiInterval pyramid_level(const Pyramid& pyr, int j,
                                                          unsigned code, int c) {
  const int4 e = __ldg(level_row(pyr, j, code >> (2 * (c - j))));
  return lrsc::BiInterval{e.x, e.y, e.z, e.w};
}

// The ladder's step from level j to j + 1 (ladder.cuh's rule: a symbol of
// rank 0 extends, PAD or the row's end freezes the state, an empty strand
// is not stepped); a lane with a strand to step steps both in one round of
// loads, one index row for both ends of an interval where they share a
// block, and a lane with none skips the step.
__device__ __forceinline__ void step_level(const lrsc::BlockRank& fwd,
                                           const lrsc::BlockRank& rev,
                                           const int8_t* __restrict__ row, int p, int L, int j,
                                           lrsc::BiInterval& st) {
  const int nxt = p + j < L ? (int)row[p + j] : lrsc::kPadRank;
  const bool live = nxt < lrsc::kPadRank;
  const bool fv = live && st.f_lo <= st.f_hi, rv = live && st.r_lo <= st.r_hi;
  if (fv || rv) {
    const int s = min(max(nxt, 0), 4);
    lrsc::update_interval_shared(fwd.blocks, fwd.ckpt, fwd.C, fwd.nb, s, st.f_lo, st.f_hi, fv);
    lrsc::update_interval_shared(rev.blocks, rev.ckpt, rev.C, rev.nb, lrsc::comp(s), st.r_lo,
                                 st.r_hi, rv);
  }
}

__global__ void kmer_table_full_kernel(lrsc::BlockRank fwd, lrsc::BlockRank rev, Pyramid pyr,
                                       const int8_t* __restrict__ reads,
                                       const int* __restrict__ lens, int R, int L,
                                       int max_k, int* __restrict__ freq,
                                       bool* __restrict__ valid) {
  Lane ln;
  if (!lane_of(fwd, rev, reads, lens, R, L, ln)) return;
  const size_t plane = (size_t)R * L;
  auto emit = [&](int j, const lrsc::BiInterval& s) {
    const bool fake = ln.p + j > ln.len;
    freq[j * plane + ln.id] = fake ? -1 : s.size();
    valid[j * plane + ln.id] = !fake && s.valid();
  };
  freq[ln.id] = -1;
  valid[ln.id] = false;
  if (max_k < 1) return;
  // c: the lane's clean prefix, at most ck and max_k
  unsigned code;
  const int c = clean_prefix(ln.row + ln.p, min(min(pyr.ck, max_k), L - ln.p), code);
  // levels 1..c: one independent load each
  lrsc::BiInterval st = ln.st;  // level 1 by init_bi when c = 0
#pragma unroll 4
  for (int j = 1; j <= c; ++j) {
    st = pyramid_level(pyr, j, code, c);
    emit(j, st);
  }
  if (c == 0) emit(1, st);
  // levels past c: the ladder
  for (int j = max(c, 1); j < max_k; ++j) {
    step_level(fwd, rev, ln.row, ln.p, L, j, st);
    emit(j + 1, st);
  }
}

// The wire table's rows of one owned lane: int16 freq clipped at 32767,
// and the valid bits of each lane's 8-level group in a register until its
// last level (or max_k), bit b of byte g = row 8g + b.
struct WireOut {
  int16_t* __restrict__ freq;
  uint8_t* __restrict__ vbits;
  size_t plane;
  int max_k;
  unsigned bits;  // byte i: owned lane i's pending group

  __device__ __forceinline__ void row(int i, size_t lane, int j, int f, bool v) {
    freq[j * plane + lane] = (int16_t)min(f, 32767);
    if (v) bits |= 1u << (8 * i + (j & 7));
    if ((j & 7) == 7 || j == max_k) {
      vbits[(j >> 3) * plane + lane] = (uint8_t)(bits >> (8 * i));
      bits &= ~(0xffu << (8 * i));
    }
  }
};

// kmer_table_wire: kmer_table_full's rows in wire format.  Each owned
// lane's rows up to its clean prefix c (at most ck and max_k) from the
// pyramid, as kmer_table_full reads them, or row 1 by init_bi when c = 0;
// past them the compacted ladder of lane_list.cuh.  ck = 0: every lane
// from level 1.
__global__ void __launch_bounds__(lrsc::kListThreads)
    kmer_table_wire_kernel(lrsc::BlockRank fwd, lrsc::BlockRank rev, Pyramid pyr,
                           const int8_t* __restrict__ reads, const int* __restrict__ lens,
                           int R, int L, int max_k, int16_t* __restrict__ freq,
                           uint8_t* __restrict__ vbits) {
  __shared__ lrsc::LaneList sh;
  const size_t lanes = (size_t)R * L, base = (size_t)blockIdx.x * lrsc::kListLanes;
  WireOut out{freq, vbits, lanes, max_k, 0u};
  lrsc::Owned own;
  lrsc::list_begin(sh, max_k, reads, base, lanes);
  __syncthreads();
  const int cmax = min(pyr.ck, max_k);
#pragma unroll
  for (int i = 0; i < lrsc::kOwned; ++i) {
    const int id = lrsc::kListThreads * i + (int)threadIdx.x;
    const size_t lane = base + id;
    own.s[i] = 0;
    if (lane >= lanes) continue;
    const int r = (int)(lane / L), p = (int)(lane - (size_t)r * L);
    const int lim = __ldg(lens + r) - p;
    out.row(i, lane, 0, -1, false);
    if (max_k < 1) continue;
    // the clean prefix c from the staged symbols (the rule written out
    // here, every symbol read before any test, ran 5% slower from the
    // pyramid and 7% faster from level 1: PERF.md §6 row 7), then its
    // levels' pyramid entries, all loads issued together
    unsigned code;
    const int c = clean_prefix(sh.sym + id, min(cmax, L - p), code);
    lrsc::BiInterval e[kMaxPyramid];
#pragma unroll
    for (int x = 0; x < kMaxPyramid; ++x)
      if (x < c) e[x] = pyramid_level(pyr, x + 1, code, c);
    lrsc::BiInterval st;  // level max(c, 1)
    if (c == 0) {
      st = lrsc::init_bi(fwd, rev, min(max((int)sh.sym[id], 0), 4));
      out.row(i, lane, 1, 1 > lim ? -1 : st.size(), 1 <= lim && st.valid());
    }
#pragma unroll
    for (int x = 0; x < kMaxPyramid; ++x) {
      if (x < c) {
        st = e[x];
        out.row(i, lane, x + 1, x + 1 > lim ? -1 : st.size(), x + 1 <= lim && st.valid());
      }
    }
    lrsc::list_start(sh, own, out, i, id, lane, max(c, 1), lim, st, max_k);
  }
  __syncthreads();
  lrsc::list_run(fwd, rev, reads, base, max_k, sh, own, out);
}

// kmer_freq_scan: the table's rows at the pool's sizes only.  A lane stops
// at min(the pool's top, len - p), past which every entry is fake (-1,
// no step); the entries at most its clean prefix c (at most ck) are one
// independent pyramid load each, and the ladder of ladder.cuh runs from
// level c (one more load, or init_bi when c = 0) to the last entry before
// the stop.  That ladder steps strand by strand, each end of an interval
// from its own row: 64 registers and no stack on an H100, against 114 and
// a 336-byte frame with kmer_table_full's step (one round of loads for
// both strands), which ran 7% slower from the pyramid and 28% from level
// 1 (PERF.md).  ck = 0: the ladder from level 1 for every lane.
__global__ void kmer_freq_scan_kernel(lrsc::BlockRank fwd, lrsc::BlockRank rev, Pyramid pyr,
                                      const int8_t* __restrict__ reads,
                                      const int* __restrict__ lens, int R, int L,
                                      Pool pool, int* __restrict__ freq) {
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (size_t)R * L) return;
  const int r = (int)(lane / L), p = (int)(lane - (size_t)r * L);
  const int8_t* row = reads + (size_t)r * L;
  const size_t plane = (size_t)R * L;
  const int len = __ldg(lens + r);
  const int stop = min(pool.k[pool.n - 1], len - p);
  unsigned code;
  const int c = clean_prefix(row + p, min(min(pyr.ck, stop), L - p), code);
  int i = 0;  // the next pool entry
  for (; i < pool.n && pool.k[i] <= c; ++i)
    freq[i * plane + lane] = pyramid_level(pyr, pool.k[i], code, c).size();
  int top = i;  // one past the last entry at most stop
  while (top < pool.n && pool.k[top] <= stop) ++top;
  if (top > i) {
    const lrsc::BiInterval st = c > 0 ? pyramid_level(pyr, c, code, c)
                                      : lrsc::init_bi(fwd, rev, min(max((int)row[p], 0), 4));
    lrsc::ladder(fwd, rev, row, p, L, len, max(c, 1), pool.k[top - 1], st,
                 [&](int j, bool, const lrsc::BiInterval& s) {
                   if (j == pool.k[i]) freq[i++ * plane + lane] = s.size();
                 });
  }
  for (; i < pool.n; ++i) freq[i * plane + lane] = -1;
}

unsigned grid(int R, int L) {
  return (unsigned)(((size_t)R * L + kThreads - 1) / kThreads);
}

}  // namespace

// pyr_lower, pyr_top: the pyramid's levels 1..ck-1 and ck (int32 [n, 4],
// 16-byte aligned), ck in 0..12; ck = 0 takes no table.
extern "C" int lrsc_kmer_table_full(const int8_t* f_blocks, const int* f_ckpt,
                                    const int* f_C, int f_nb, const int8_t* r_blocks,
                                    const int* r_ckpt, const int* r_C, int r_nb,
                                    const int* pyr_lower, const int* pyr_top, int ck,
                                    const int8_t* reads, const int* lens, int R,
                                    int L, int max_k, int* freq, bool* valid,
                                    void* stream) {
  if (ck < 0 || ck > kMaxPyramid) return (int)cudaErrorInvalidValue;
  if (grid(R, L) > 0) {
    kmer_table_full_kernel<<<grid(R, L), kThreads, 0, (cudaStream_t)stream>>>(
        lrsc::BlockRank{f_blocks, f_ckpt, f_C, f_nb},
        lrsc::BlockRank{r_blocks, r_ckpt, r_C, r_nb},
        Pyramid{reinterpret_cast<const int4*>(pyr_lower),
                reinterpret_cast<const int4*>(pyr_top), ck},
        reads, lens, R, L, max_k, freq, valid);
  }
  return (int)cudaGetLastError();
}

// pyr_lower, pyr_top, ck: as for lrsc_kmer_table_full.
extern "C" int lrsc_kmer_table_wire(const int8_t* f_blocks, const int* f_ckpt,
                                    const int* f_C, int f_nb, const int8_t* r_blocks,
                                    const int* r_ckpt, const int* r_C, int r_nb,
                                    const int* pyr_lower, const int* pyr_top, int ck,
                                    const int8_t* reads, const int* lens, int R,
                                    int L, int max_k, int16_t* freq, uint8_t* vbits,
                                    void* stream) {
  if (ck < 0 || ck > kMaxPyramid || max_k < 0) return (int)cudaErrorInvalidValue;
  const size_t blocks = ((size_t)R * L + lrsc::kListLanes - 1) / lrsc::kListLanes;
  if (blocks > 0) {
    kmer_table_wire_kernel<<<(unsigned)blocks, lrsc::kListThreads, 0,
                             (cudaStream_t)stream>>>(
        lrsc::BlockRank{f_blocks, f_ckpt, f_C, f_nb},
        lrsc::BlockRank{r_blocks, r_ckpt, r_C, r_nb},
        Pyramid{reinterpret_cast<const int4*>(pyr_lower),
                reinterpret_cast<const int4*>(pyr_top), ck},
        reads, lens, R, L, max_k, freq, vbits);
  }
  return (int)cudaGetLastError();
}

// pool: n_pool strictly ascending sizes >= 1, in host memory; n_pool <= 16.
// pyr_lower, pyr_top, ck: as for lrsc_kmer_table_full.
extern "C" int lrsc_kmer_freq_scan(const int8_t* f_blocks, const int* f_ckpt,
                                   const int* f_C, int f_nb, const int8_t* r_blocks,
                                   const int* r_ckpt, const int* r_C, int r_nb,
                                   const int* pyr_lower, const int* pyr_top, int ck,
                                   const int8_t* reads, const int* lens, int R, int L,
                                   const int* pool, int n_pool, int* freq,
                                   void* stream) {
  if (n_pool < 1 || n_pool > kMaxPool || ck < 0 || ck > kMaxPyramid)
    return (int)cudaErrorInvalidValue;
  Pool p{n_pool, {}};
  for (int i = 0; i < n_pool; ++i) p.k[i] = pool[i];
  if (grid(R, L) > 0) {
    kmer_freq_scan_kernel<<<grid(R, L), kThreads, 0, (cudaStream_t)stream>>>(
        lrsc::BlockRank{f_blocks, f_ckpt, f_C, f_nb},
        lrsc::BlockRank{r_blocks, r_ckpt, r_C, r_nb},
        Pyramid{reinterpret_cast<const int4*>(pyr_lower),
                reinterpret_cast<const int4*>(pyr_top), ck},
        reads, lens, R, L, p, freq);
  }
  return (int)cudaGetLastError();
}
