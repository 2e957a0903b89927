// The compacted ladder of a k-mer table past its start level, run by
// kmer_table.cu's wire kernel (a template over the rank and the table's
// row writer; tools/prof_tables.py also runs planes.cu's table on it).
//
// Replaces, as ladder.cuh does for the other table kernels, the level loop
// of the JAX package's ops/scan.py kmer_table_full (:124-139), which
// kmer_table_wire (:143) runs.
//
// Bound on the H100: past its start level a lane's LF steps are dependent
// random index reads, and at 8% error the lanes die at different levels
// (half of those live at level 12 are gone by level 15, a few reach 51).
// With one thread per lane a warp keeps stepping while any of its 32 lanes
// lives, so many of its rounds of loads issue for a few lanes (PERF.md §6
// row 7).
//
// Design: a block takes kListLanes consecutive lanes; each of its threads
// owns kOwned of them (lane = kListThreads * i + thread), so that every
// table row of the block is written with coalesced stores.  The owner
// reads each lane's start (the pyramid or the wcache) and writes its rows
// up to the start level.  A lane that is settled there (the top level,
// both strands empty, or its window at the read's end) gets its remaining
// rows as constants at once: -1 where fake, else size 0, valid false.
// Every other lane keeps its state (16 bytes) in shared memory, indexed by
// lane, and its id joins a list of live lanes.  The ladder then runs level
// by level: the threads step the list's lanes, 32 live lanes a warp, both
// strands of a lane in one round of loads, and write each lane's result to
// a shared stage; the survivors' ids are compacted into
// the next level's list (a ballot and one shared atomic a warp).  Then
// each owner writes the level's row of its lanes, from the stage or as the
// settled constant, and adds the lanes whose start is the next level.
// A live lane is never fake: it leaves the list at the last level inside
// its read.
#pragma once

#include <cstdint>

#include "ladder.cuh"

namespace lrsc {

constexpr int kListThreads = 128;                  // threads a block
constexpr int kListLanes = 256;                    // lanes a block
constexpr int kOwned = kListLanes / kListThreads;  // lanes a thread owns
constexpr int kSymPad = 64;                        // symbols staged past the block's lanes
constexpr int kSymSpan = kListLanes + kSymPad;

// the block's lanes past their start: by lane, the state (f_lo, f_hi, r_lo,
// r_hi) and len - p, and the level's result (stage_v 0: none, 1: staged,
// 3: staged and valid); the live lanes' ids, two lists in turn; the read
// symbols from the block's first lane on (sym[id + j] = reads[lane + j],
// PAD past the table)
struct LaneList {
  int4 st[kListLanes];
  int8_t sym[kSymSpan];
  int lim[kListLanes];
  int stage_f[kListLanes];
  uint8_t stage_v[kListLanes];
  uint16_t ids[2][kListLanes];
  int n[2];
  int neg_lo, hi;  // minus the least and the largest start level of a live lane
};

// The owner's lanes: the start level of each live one (0: no lane, or
// settled at its start with every row written), and its len - p.
struct Owned {
  int s[kOwned];
  int lim[kOwned];
};

__device__ __forceinline__ int4 as_int4(const BiInterval& b) {
  return make_int4(b.f_lo, b.f_hi, b.r_lo, b.r_hi);
}

__device__ __forceinline__ BiInterval as_bi(const int4& v) {
  return BiInterval{v.x, v.y, v.z, v.w};
}

// Appends the ids of the warp's lanes with keep to list `which`: a ballot,
// one shared atomic a warp.  Every thread of the warp calls it.
__device__ __forceinline__ void append(LaneList& sh, int which, bool keep, int id) {
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (m == 0u) return;
  const int ln = (int)(threadIdx.x & 31u);
  int at = 0;
  if (ln == 0) at = atomicAdd(&sh.n[which], __popc(m));
  at = __shfl_sync(0xffffffffu, at, 0);
  if (keep) sh.ids[which][at + __popc(m & ((1u << ln) - 1u))] = (uint16_t)id;
}

// Before any lane's start: the counters and the block's symbols.  A
// __syncthreads follows.
__device__ __forceinline__ void list_begin(LaneList& sh, int max_k,
                                           const int8_t* __restrict__ reads, size_t base,
                                           size_t lanes) {
  if (threadIdx.x == 0) {
    sh.n[0] = sh.n[1] = 0;
    sh.neg_lo = -max_k;
    sh.hi = 0;
  }
  for (int x = (int)threadIdx.x; x < kSymSpan; x += kListThreads)
    sh.sym[x] = base + x < lanes ? __ldg(reads + base + x) : (int8_t)kPadRank;
}

// Owned lane i (block lane id, table lane `lane`) after its rows up to its
// start level s, with state st there and lim = len - p: settled (its rows
// past s written as constants), or live.
template <class Out>
__device__ __forceinline__ void list_start(LaneList& sh, Owned& own, Out& out, int i, int id,
                                           size_t lane, int s, int lim, const BiInterval& st,
                                           int max_k) {
  if (s >= max_k || s >= lim || !(st.f_lo <= st.f_hi || st.r_lo <= st.r_hi)) {
    for (int j = s + 1; j <= max_k; ++j) out.row(i, lane, j, j > lim ? -1 : 0, false);
    own.s[i] = 0;
    return;
  }
  own.s[i] = s;
  own.lim[i] = lim;
  sh.st[id] = as_int4(st);
  sh.lim[id] = lim;
  atomicMax(&sh.neg_lo, -s);
  atomicMax(&sh.hi, s);
}

// One LF step of both strands by symbol nxt (ladder.cuh's rule: PAD
// freezes the state, an empty strand is not stepped), both in one round of
// loads, one index row for both ends of an interval where they share a
// block (Rank::update_shared).  ladder.cuh's strand-by-strand step
// (Rank::update) ran 1.9x slower here (PERF.md §6 row 7).
template <class Rank>
__device__ __forceinline__ void list_step(const Rank& fwd, const Rank& rev, int nxt,
                                          BiInterval& st) {
  const bool live = nxt < kPadRank;
  const int s = min(max(nxt, 0), 4);
  const bool fv = live && st.f_lo <= st.f_hi, rv = live && st.r_lo <= st.r_hi;
  fwd.update_shared(s, st.f_lo, st.f_hi, fv);
  rev.update_shared(comp(s), st.r_lo, st.r_hi, rv);
}

// The ladder of the block's live lanes, level by level, to max_k, then
// the settled lanes' remaining rows.  reads + base: the block's first
// lane's symbol (lane + j is the symbol at p + j inside the read).
template <class Rank, class Out>
__device__ __forceinline__ void list_run(const Rank& fwd, const Rank& rev,
                                         const int8_t* __restrict__ reads, size_t base,
                                         int max_k, LaneList& sh, const Owned& own, Out& out) {
  const int t = (int)threadIdx.x;
  const int lo = -sh.neg_lo, hi = sh.hi;
  // the first list: the live lanes that start at the least level
#pragma unroll
  for (int i = 0; i < kOwned; ++i)
    append(sh, lo & 1, own.s[i] != 0 && own.s[i] == lo, kListThreads * i + t);
  __syncthreads();
  int j = lo;
  for (; j < max_k; ++j) {
    const int cur = j & 1, nxt_list = cur ^ 1;
    const int n = sh.n[cur];
    if (n == 0 && j >= hi) break;
    // step the list's lanes from level j to j + 1
    for (int b = 0; b < n; b += kListThreads) {
      if (b + (t & ~31) >= n) break;  // the warp's lanes all past the list
      const bool on = b + t < n;
      const int id = on ? (int)sh.ids[cur][b + t] : 0;
      BiInterval st = on ? as_bi(sh.st[id]) : BiInterval{1, 0, 1, 0};
      // a listed lane has j < len - p: its symbol lies inside its read
      const int sym = !on                 ? kPadRank
                      : id + j < kSymSpan ? (int)sh.sym[id + j]
                                          : (int)__ldg(reads + base + id + j);
      list_step(fwd, rev, sym, st);
      const bool fv = st.f_lo <= st.f_hi, rv = st.r_lo <= st.r_hi;
      const bool keep = on && (fv || rv) && j + 1 < max_k && j + 1 < sh.lim[id];
      if (on) {
        sh.stage_f[id] = st.size();
        sh.stage_v[id] = (uint8_t)(1 | ((fv && rv) ? 2 : 0));
        if (keep) sh.st[id] = as_int4(st);
      }
      append(sh, nxt_list, keep, id);
    }
    __syncthreads();
    // level j + 1's row of every owned lane past its start; the lanes that
    // start at j + 1 join the next list
#pragma unroll
    for (int i = 0; i < kOwned; ++i) {
      const int id = kListThreads * i + t;
      if (own.s[i] != 0 && own.s[i] <= j) {
        const int v = sh.stage_v[id];
        if (v) {
          out.row(i, base + id, j + 1, sh.stage_f[id], v == 3);
          sh.stage_v[id] = 0;
        } else {
          out.row(i, base + id, j + 1, j + 1 > own.lim[i] ? -1 : 0, false);
        }
      }
      if (j < hi) append(sh, nxt_list, own.s[i] != 0 && own.s[i] == j + 1, id);
    }
    if (t == 0) sh.n[cur] = 0;
    __syncthreads();
  }
  // every lane settled: the rows past j are constants
  for (int r = j + 1; r <= max_k; ++r) {
#pragma unroll
    for (int i = 0; i < kOwned; ++i)
      if (own.s[i] != 0) out.row(i, base + kListThreads * i + t, r, r > own.lim[i] ? -1 : 0,
                                 false);
  }
}

}  // namespace lrsc
