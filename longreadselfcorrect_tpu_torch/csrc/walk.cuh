// The FM-extension walk of one gap lane, as __device__ functions shared by
// the kernels of walk.cu.
//
// Replaces the JAX package's ops/walk.py superstep (:997-1593) with its
// helpers (:691-978), _reduce_results (:1600), the lane seeding of
// _init_state (:521) and the per-task prep of _prep_core (:371-518).
//
// One warp walks one gap lane.  The lane's state lives in shared memory
// for the whole launch (the layout of `lane_layout`, mirrored by
// ops/walk.py lane_smem_bytes):
//   * two records per leaf slot (the scalars, the chain ring and the error
//     ring of the leaf); a slot's current record is the one its bit of
//     `owner` names, and a step writes a new leaf into the slot's other
//     record while every parent is read from its current one, so nothing
//     is copied back;
//   * the labels as a per-position history: byte [pos * L + l] holds the
//     symbol at pos of the label of the leaf in slot l when it was made,
//     and the slot of that leaf's parent (3 + 5 bits).  A label is read
//     back by walking the parents from its last position down to 0, once
//     per result or per write-back; the loaded labels enter as positions
//     whose parent is their own slot;
//   * per-candidate scratch of one superstep, and the result slots.
// The per-lane scalars (code, cur_len, cur_k, gerr_n, res_count, the
// alive and owner bitmasks) are warp-uniform registers.
//
// A superstep is a sequence of rounds, each a set of independent items
// spread over the warp's 32 threads (item i on thread i mod 32): the leaf
// tests, the 4-way probes of every live leaf (thread = leaf, base, side:
// one LF each), the level-1 probes, the isInsufficientFreqs refine (3 x
// candidates x 2 sides), the per-candidate seed support, error rate and
// termination, the chain rebuild of every new leaf (leaf, level, side).
// The rank queries of a round are independent, so a round costs about one
// memory latency.  Every lane-level decision comes out of a warp
// collective and is the same on every thread, so the warp never diverges
// on it.  The tie-breaks are the serial loop's: leaf compaction in
// candidate order (ballot prefix counts), new result slots in candidate
// order (the same), the last writer per result slot (the largest
// candidate, atomicMax), the seed match's first strict minimum (the least
// (diff, pos) key, atomicMin), isTerminated's last window (atomicMax);
// min/max reductions are exact in any order.  The error rates are the
// host engine's (core/extend.py): each leaf carries num_redeem_seed as a
// running f64 sum (the record's F_NRS), and a candidate's
// computeErrorRate, the erase test, the prune bound, the retry minimum and
// the result choice run in f64 in the host's order, in one thread, with
// __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn, so nothing is contracted
// (the file is built with -fmad=false, which the f32 ratio cutoffs need).
// A tie among distinct leaves at the minimum is then decided as the host
// decides it; the lane keeps an informational `tie` bit.
//
// Rank queries go through rank.cuh directly: where the JAX slab engine
// (SLAB configs) reads a rank off a block slab, every such query lies in
// the slab, so the value is the direct rank; only the slab span test and
// its -300 escape, and the slab path's (0, -1) for empty intervals, stay.
#pragma once

#include <cstdint>

#include "rank.cuh"

namespace lrsc {
namespace walk {

constexpr int kPad = 5;
constexpr unsigned kFull = 0xffffffffu;

struct Index {
  const int8_t* fb;  // RBWT blocks (the fwd side of the bi-interval)
  const int* fck;
  const int* fC;
  const int8_t* rb;  // BWT blocks (the rvc side)
  const int* rck;
  const int* rC;
  int fnb, rnb;
  const int* wcache;  // [4^ck, 4]
};

struct Cfg {
  int L, MAXLEN, QMAX, TMAX, RMAX, RING, KMAX, SS, MAXLEAVES, CK, SLAB, SB, NC;
};

// per-task constants, rows indexed by task
struct Consts {
  const int8_t* query;
  const int* q_len;
  const int8_t* trg;
  const int* trg_len;
  const int* n_term;
  const int* term_f;
  const int* term_r;
  const int* qcode9;
  const int* qcode5;
  const int* init_k;
  const int* max_overlap;
  const int* min_overlap;
  const int* min_sa;
  const int* max_indel;
  const int* max_length;
  const int* min_length;
  const bool* no_term;
  const float* freqs;
  const double* redeem;     // the num_redeem_seed adds: (SS - 1) * e, 1 - e
  const double* err_bound;  // the prune bound on a leaf's local error
};

struct Root {
  const int* f_lo;
  const int* f_hi;
  const int* r_lo;
  const int* r_hi;
  const int* freq;
  const int* chain0;
  const int* tail9;
  const int* tail8;
  const int8_t* tail_letter;
  const int* tail_count;
};

struct State {
  int8_t* labels;
  int *f_lo, *f_hi, *r_lo, *r_hi;
  bool* alive;
  int *kmer_freq, *total_kmer, *last_seed_idx, *last_overlap_len, *total_seeds,
      *curr_overlap_len, *num_errors, *seed_idx_offset, *query_overlap_len;
  double* nrs;
  int *res_first, *res_second;
  int8_t* tail_letter;
  int *tail_count, *tail9, *tail8, *chain;
  double *local_err, *gerr_last, *ring;
  bool* active;
  int *cur_len, *cur_k, *gerr_n, *code;
  int8_t* res_labels;
  int* res_len;
  double* res_err;
  int *res_i, *res_count;
  bool* res_overflow;
  bool* res_tie;  // sticky: distinct leaves tied at the minimum and gated a retry
};

struct Reduced {
  int* code;
  bool* overflow;
  bool* has;
  int8_t* lab;
  int* len;
  int* i;
  bool* tie;  // the walk resolved a tie (res_tie)
};

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) { return a - floordiv(a, b) * b; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }
__device__ __forceinline__ int isize(int lo, int hi) { return max(hi - lo + 1, 0); }

// LF of [lo, hi] by sym on one side, raw (no validity test)
__device__ __forceinline__ void lf_f(const Index& ix, int sym, int& lo, int& hi) {
  update_interval(ix.fb, ix.fck, ix.fC, ix.fnb, sym, lo, hi);
}
__device__ __forceinline__ void lf_r(const Index& ix, int sym, int& lo, int& hi) {
  update_interval(ix.rb, ix.rck, ix.rC, ix.rnb, sym, lo, hi);
}
// side 0: the fwd interval by sym; side 1: the rvc interval by comp(sym)
__device__ __forceinline__ void lf_side(const Index& ix, int side, int sym, int& lo, int& hi) {
  if (side == 0)
    lf_f(ix, sym, lo, hi);
  else
    lf_r(ix, comp(sym), lo, hi);
}

// the walk-convention bi-interval extension (rank.extend_bi): append sym;
// each side reads one index row for both ends where they share a block
__device__ __forceinline__ void extend_bi(const Index& ix, int sym, int* st) {
  update_interval_shared(ix.fb, ix.fck, ix.fC, ix.fnb, sym, st[0], st[1]);
  update_interval_shared(ix.rb, ix.rck, ix.rC, ix.rnb, comp(sym), st[2], st[3]);
}
__device__ __forceinline__ void init_bi(const Index& ix, int sym, int* st) {
  st[0] = __ldg(ix.fC + sym);
  st[1] = __ldg(ix.fC + sym + 1) - 1;
  const int c = comp(sym);
  st[2] = __ldg(ix.rC + c);
  st[3] = __ldg(ix.rC + c + 1) - 1;
}
__device__ __forceinline__ void wcache_get(const Index& ix, int code, int* st) {
  const int4 w = __ldg(reinterpret_cast<const int4*>(ix.wcache) + code);
  st[0] = w.x;
  st[1] = w.y;
  st[2] = w.z;
  st[3] = w.w;
}

__device__ __forceinline__ bool cutoff(int freq, int total, int maxf, bool m5,
                                       int tailc, int t) {
  const float ratio = __fdiv_rn((float)freq, (float)maxf);
  float cut = 2.0f;
  if (total >= t + 2) cut = 0.6f;
  if (freq >= t) cut = 0.25f;
  if (m5 && maxf > 50) cut = 0.2f;
  if (m5 && maxf > 150) cut = 0.125f;
  if (tailc >= 3) cut = maxf > 100 ? fmaxf(cut, 0.3f) : fmaxf(cut, 0.6f);
  return ratio >= cut;
}

// SelectFreqsOfrange (:281-331) from the masked maxima of the three sizes
__device__ __forceinline__ int select_freqs(const Consts& K, const int (&maxf)[3], int lower,
                                            int upper) {
  int rs = upper;
  bool decided = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int ln = lower + i;
    const int expected = (int)K.freqs[clampi(ln, 0, 100)];
    if (ln <= upper && maxf[i] - expected < 5 && !decided) {
      rs = ln;
      decided = true;
    }
  }
  return rs;
}

// the k-th set bit (k from 0) of m
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  for (int i = 0; i < k; ++i) m &= m - 1;
  return __ffs(m) - 1;
}
__device__ __forceinline__ unsigned low_mask(int n) {
  return n >= 32 ? kFull : (1u << n) - 1u;
}
__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ const double& f64(const int* p) {
  return *reinterpret_cast<const double*>(p);
}
__device__ __forceinline__ double& f64(int* p) { return *reinterpret_cast<double*>(p); }
__device__ __forceinline__ int warp_max(int v) {
  return (int)__reduce_max_sync(kFull, (unsigned)max(v, 0));
}

// ---------------------------------------------------------------------------
// the lane's shared-memory layout (bytes), mirrored by ops/walk.py
// lane_smem_bytes
// ---------------------------------------------------------------------------

// leaf record: the int scalars, the f64 ones (two ints each, 8-byte
// aligned: the local and the last global error, num_redeem_seed), two
// ints of padding, then the chain ring [4][NC], then the error ring of RING
// doubles rounded up to a pair (copied as 16-byte vectors)
enum Field {
  F_FLO, F_FHI, F_RLO, F_RHI, F_KFREQ, F_TOTK, F_LSEED, F_LOVL, F_TSEEDS, F_COVL,
  F_NERR, F_SIO, F_QOVL, F_RF, F_RS, F_TLET, F_TCNT, F_T9, F_T8, F_LEN,
  F_LERR = 20, F_GLAST = 22, F_NRS = 24, kScal = 28
};
// candidate scratch: [0, 16) the level-0 and level-1 probes (5 + 5), then
// the refine's three levels (12), then the new counters (NewField, the f64
// ones at even ints); the chosen interval and freq at 16; the seed key at
// 21 and isTerminated's last window at 22
constexpr int kCandW = 24, C_P0 = 0, C_P1 = 5, C_CI = 16, C_KEY = 21, C_IMAX = 22;
enum NewField {
  N_LSEED, N_LOVL, N_TSEEDS, N_COVL, N_NERR, N_SIO, N_QOVL, N_RF, N_RS,
  N_GERR = 10, N_LOCAL = 12, N_NRS = 14
};

struct Layout {
  int RS;                                  // ints per leaf record
  int rec, cand, res, lsrc, hist, total;   // byte offsets, total bytes
};

__host__ __device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ __forceinline__ Layout lane_layout(const Cfg& c) {
  Layout y;
  y.RS = kScal + 4 * c.NC + 2 * ((c.RING + 1) & ~1);
  int off = 0;
  y.rec = off;
  off += 2 * c.L * y.RS * 4;
  y.cand = off;
  off += 4 * c.L * kCandW * 4;
  y.res = off;  // res_err (f64), res_len, res_i, res_ref, src: [RMAX] each
  off += align16(6 * c.RMAX * 4);
  y.lsrc = off;
  off += align16(c.L * 4);
  y.hist = off;
  off += align16(c.MAXLEN * c.L);
  y.total = off;
  return y;
}

// ---------------------------------------------------------------------------
// one gap lane, walked by one warp
// ---------------------------------------------------------------------------

template <int LM>
struct Walker {
  static constexpr int NW = (4 * LM + 31) / 32;  // candidate rounds / mask words

  const Index& ix;
  const Cfg& cf;
  const Consts& K;
  char* sm;
  Layout Y;
  int lane;
  int t;  // task row of the constants
  int max_length, max_overlap, min_overlap, min_sa, max_indel, q_len, min_length, n_term;
  bool no_term;
  // warp-uniform lane state
  bool active, overflow, tie;
  int code, cur_len, cur_k, gerr_n, res_count;
  unsigned alive, owner;

  __device__ __forceinline__ Walker(const Index& ix_, const Cfg& cf_, const Consts& K_, char* sm_)
      : ix(ix_), cf(cf_), K(K_), sm(sm_), Y(lane_layout(cf_)), lane(threadIdx.x & 31) {}

  __device__ __forceinline__ int* rec(int buf, int l) const {
    return reinterpret_cast<int*>(sm + Y.rec) + (buf * cf.L + l) * Y.RS;
  }
  __device__ __forceinline__ int* cur(int l) const { return rec((owner >> l) & 1, l); }
  __device__ __forceinline__ int* nxt(int l) const { return rec(((owner >> l) & 1) ^ 1, l); }
  __device__ __forceinline__ double* ring(const int* r) const {
    return reinterpret_cast<double*>(const_cast<int*>(r) + kScal + 4 * cf.NC);
  }
  __device__ __forceinline__ int* cnd(int c) const {
    return reinterpret_cast<int*>(sm + Y.cand) + c * kCandW;
  }
  __device__ __forceinline__ double* res_err() const {
    return reinterpret_cast<double*>(sm + Y.res);
  }
  __device__ __forceinline__ int* res_len() const {
    return reinterpret_cast<int*>(sm + Y.res) + 2 * cf.RMAX;
  }
  __device__ __forceinline__ int* res_i() const { return res_len() + cf.RMAX; }
  __device__ __forceinline__ int* res_ref() const { return res_len() + 2 * cf.RMAX; }
  __device__ __forceinline__ int* src() const { return res_len() + 3 * cf.RMAX; }
  __device__ __forceinline__ int* lsrc() const { return reinterpret_cast<int*>(sm + Y.lsrc); }
  __device__ __forceinline__ uint8_t* hist() const { return reinterpret_cast<uint8_t*>(sm + Y.hist); }

  __device__ __forceinline__ static bool bit(const unsigned* w, int c) {
    bool b = false;
#pragma unroll
    for (int k = 0; k < NW; ++k)
      if (k == (c >> 5)) b = (w[k] >> (c & 31)) & 1;
    return b;
  }
  __device__ __forceinline__ static int count(const unsigned* w) {
    int n = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) n += __popc(w[k]);
    return n;
  }
  // the k-th set candidate of w
  __device__ __forceinline__ static int nth(const unsigned* w, int k) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int n = __popc(w[q]);
      if (k < n) return 32 * q + nth_bit(w[q], k);
      k -= n;
    }
    return -1;
  }

  __device__ __forceinline__ void load_task(int task) {
    t = task;
    max_length = K.max_length[t];
    max_overlap = K.max_overlap[t];
    min_overlap = K.min_overlap[t];
    min_sa = K.min_sa[t];
    max_indel = K.max_indel[t];
    q_len = K.q_len[t];
    min_length = K.min_length[t];
    n_term = K.n_term[t];
    no_term = K.no_term[t];
  }

  // 4-way probes (probe4) of every leaf in `leaves` into candidate field
  // po: item = (leaf, base, side), one LF each; j >= 0 probes chain slot j,
  // j < 0 the leaf interval (replaced by chain slot jmo when ref0)
  __device__ __forceinline__ void probe(unsigned leaves, int po, int j, bool ref0, int jmo) const {
    const int NC = cf.NC, n = 8 * __popc(leaves);
    for (int i = lane; i < n; i += 32) {
      const int l = nth_bit(leaves, i >> 3), b = (i >> 1) & 3, side = i & 1;
      const int* r = cur(l);
      int lo, hi;
      if (j >= 0 || ref0) {
        const int jj = j >= 0 ? j : jmo;
        lo = r[kScal + 2 * side * NC + jj];
        hi = r[kScal + (2 * side + 1) * NC + jj];
      } else {
        lo = r[F_FLO + 2 * side];
        hi = r[F_FHI + 2 * side];
      }
      if (lo <= hi) lf_side(ix, side, b + 1, lo, hi);
      int* P = cnd(4 * l + b) + po;
      P[2 * side] = lo;
      P[2 * side + 1] = hi;
    }
    __syncwarp();
    for (int c = lane; c < 4 * cf.L; c += 32)
      if ((leaves >> (c >> 2)) & 1) {
        int* P = cnd(c) + po;
        P[4] = isize(P[0], P[1]) + isize(P[2], P[3]);
      }
    __syncwarp();
  }

  // `attempt` (+ _leaf_choice) on the probes at po for the alive1 leaves:
  // ext at threshold min_sa (retry at min_sa - 1); with lvl2, also level
  // 2's ext (threshold min_sa - 1, retry at min_sa - 2); tie1 / tie2: a
  // leaf of the tied mask needed its retry at that level
  __device__ __forceinline__ void attempt(int po, unsigned alive1, unsigned retry, unsigned tied,
                          const unsigned* m5w, bool lvl2, unsigned* ext, unsigned* ext2,
                          bool& tie1, bool& tie2) const {
    const int C = 4 * cf.L;
    bool h = false, h2 = false;
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int c = 32 * r + lane, l = c >> 2, b = c & 3;
      const bool in = c < C && ((alive1 >> (l & 31)) & 1);
      bool mt = false, mt1 = false, mt2 = false;
      if (in) {
        int total = 0, maxf = cnd(4 * l)[po + 4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int f = cnd(4 * l + x)[po + 4];
          total += f;
          maxf = max(maxf, f);
        }
        const int* P = cnd(c) + po;
        const int fqb = P[4];
        const bool m5 = (P[0] <= P[1] || P[2] <= P[3]) && bit(m5w, c);
        const int tailc = cur(l)[F_TCNT];
        mt = cutoff(fqb, total, maxf, m5, tailc, min_sa);
        mt1 = cutoff(fqb, total, maxf, m5, tailc, min_sa - 1);
        if (lvl2) mt2 = cutoff(fqb, total, maxf, m5, tailc, min_sa - 2);
      }
      const int sh = lane & ~3;
      const bool any_t = (__ballot_sync(kFull, mt) >> sh) & 0xF;
      const bool any_t1 = (__ballot_sync(kFull, mt1) >> sh) & 0xF;
      const bool any_t2 = (__ballot_sync(kFull, mt2) >> sh) & 0xF;
      const bool ret = (retry >> (l & 31)) & 1, ti = (tied >> (l & 31)) & 1;
      ext[r] = __ballot_sync(kFull, in && (any_t ? mt : (ret && mt1)));
      ext2[r] = __ballot_sync(kFull, in && (any_t1 ? mt1 : (ret && mt2)));
      h |= in && ti && !any_t && any_t1;
      h2 |= in && ti && !any_t1 && any_t2;
    }
    tie1 = __any_sync(kFull, h);
    tie2 = __any_sync(kFull, h2);
  }

  // one superstep of this lane (JAX superstep)
  __device__ __forceinline__ void step() {
    const int L = cf.L, C = 4 * L, NC = cf.NC, SS = cf.SS, CK = cf.CK;

    // while-condition on the state left by the last step
    const int n_alive = __popc(alive);
    const bool cond_ok = n_alive > 0 && n_alive <= cf.MAXLEAVES && cur_len <= max_length;
    const bool gap_go = active && code == 0;
    if (gap_go && !cond_ok) {
      if (res_count > 0) code = 1;
      else if (n_alive == 0) code = -1;
      else if (cur_len > max_length) code = -2;
      else code = -3;
    }
    if (!(gap_go && cond_ok)) return;

    const bool mine = lane < L;
    const bool alive_l = mine && ((alive >> lane) & 1);
    const int* me = mine ? cur(lane) : nullptr;

    // slab escape: the slot-0 interval of every live leaf spans <= SB blocks
    if (cf.SLAB) {
      bool bad = false;
      if (alive_l) {
        const int* ch = me + kScal;
        bool ok = true;
        for (int side = 0; side < 2; ++side) {
          const int lo0 = ch[2 * side * NC], hi0 = ch[(2 * side + 1) * NC];
          if (lo0 <= hi0 && floordiv(hi0 + 1, kBlock) - floordiv(lo0, kBlock) + 1 > cf.SB)
            ok = false;
        }
        const bool inv_f = me[F_FLO] <= me[F_FHI] && ch[0] > ch[NC];
        const bool inv_r = me[F_RLO] <= me[F_RHI] && ch[2 * NC] > ch[3 * NC];
        bad = !ok || inv_f || inv_r;
      }
      if (__any_sync(kFull, bad)) {
        code = -300;
        return;
      }
    }

    // extendLeaves: the optional kmer-size clamp refine
    const bool need_ref0 = cur_k > max_overlap;
    const int jmo = clampi(max_overlap - CK, 0, NC - 1);
    const int cur_k0 = need_ref0 ? max_overlap : cur_k;

    // attempToExtend: erase relatively bad leaves, retry eligibility (f64,
    // the host's compares)
    const double le = mine ? f64(me + F_LERR) : 2.0;
    const double ev = alive_l ? le : 2.0;
    const double min_err = warp_min(ev);
    bool erase = false;
    if (alive_l) {
      const double diff = __dsub_rn(le, min_err);
      erase = (diff > 0.05 && cur_len > cf.RING / 2) || (diff > 0.1 && cur_len > 15);
    }
    const unsigned alive1 = __ballot_sync(kFull, alive_l && !erase);
    const unsigned is_min = __ballot_sync(kFull, mine && ev == min_err);
    const unsigned retry = __popc(alive1) > 1 ? is_min : 0u;
    const unsigned tied = __popc(is_min & alive) > 1 ? retry : 0u;

    // ismatchedbykmer (:787-821) of every candidate's 5-suffix, one scan
    // of the query window: bit c = the window holds it
    unsigned m5w[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) m5w[k] = 0;
    {
      const int lo = max(cur_len - max_indel, 0), hi = min(cur_len + max_indel, cf.QMAX - 1);
      const int* row = K.qcode5 + (size_t)t * cf.QMAX;
      for (int p = lo + lane; p <= hi; p += 32) {
        const int q = __ldg(row + p), b = (q & 7) - 1;
        if (q < 0 || b < 0 || b > 3) continue;
        for (unsigned m = alive1; m; m &= m - 1) {
          const int l = __ffs(m) - 1, c = 4 * l + b;
          if ((q >> 3) != (cur(l)[F_T9] & 0xFFF)) continue;
#pragma unroll
          for (int k = 0; k < NW; ++k)
            if (k == (c >> 5)) m5w[k] |= 1u << (c & 31);
        }
      }
#pragma unroll
      for (int k = 0; k < NW; ++k) m5w[k] = __reduce_or_sync(kFull, m5w[k]);
    }

    // level 0
    probe(alive1, C_P0, cf.SLAB ? clampi(cur_k0 - CK, 0, NC - 1) : -1, need_ref0, jmo);
    unsigned extA[NW], unused[NW];
    bool tieA, tie_unused;
    attempt(C_P0, alive1, retry, tied, m5w, false, extA, unused, tieA, tie_unused);
    const bool gapA = count(extA) > 0;

    // level 1 (k reduce) + level 2 (threshold relax), only when needed
    const bool need_l1 = !gapA;
    unsigned extB[NW], extC[NW];
    bool gapB = false, gapC = false, tieBC = false;
    int reduce_size = cur_k0;
    if (need_l1) {
      const int lower = max(cur_k0 - 2, min_overlap);
      int maxf[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int j = clampi(lower + i - CK, 0, NC - 1);
        int v = 0;
        if (mine && ((alive1 >> lane) & 1)) {
          const int* ch = me + kScal;
          v = isize(ch[j], ch[NC + j]) + isize(ch[2 * NC + j], ch[3 * NC + j]);
        }
        maxf[i] = warp_max(v);
      }
      reduce_size = select_freqs(K, maxf, lower, cur_k0);
      probe(alive1, C_P1, clampi(reduce_size - CK, 0, NC - 1), false, 0);
      bool tieB, tieC;
      attempt(C_P1, alive1, retry, tied, m5w, true, extB, extC, tieB, tieC);
      gapB = count(extB) > 0;
      gapC = count(extC) > 0 && !gapB;
      tieBC = tieB || tieC;
    }
    const bool use_l1 = need_l1 && (gapB || gapC);

    // candidates c = 4 * parent + (base - 1)
    unsigned cand[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) cand[k] = gapA ? extA[k] : gapB ? extB[k] : gapC ? extC[k] : 0u;
    const int n_new = count(cand);
    const bool success = n_new > 0;
    const int po = use_l1 ? C_P1 : C_P0;
    int high_cnt = 0;
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int c = 32 * r + lane;
      bool high = false;
      if (c < C && ((cand[r] >> lane) & 1)) {
        int* X = cnd(c);
        for (int q = 0; q < 5; ++q) X[C_CI + q] = X[po + q];
        high = X[C_CI + 4] > min_sa;
      }
      high_cnt += __popc(__ballot_sync(kFull, high));
    }
    __syncwarp();
    const int cur_k_base = use_l1 ? reduce_size : cur_k0;
    const int cur_len_new = success ? cur_len + 1 : cur_len;
    int cur_k_new = success ? cur_k_base + 1 : cur_k_base;

    // isInsufficientFreqs -> reduce + refine the candidates
    const bool insuff = high_cnt == 0 || (high_cnt <= 2 && n_new >= 5) ||
                        (high_cnt <= 1 && n_new >= 3);
    if (success && insuff) {
      const int lower2 = max(cur_k_new - 2, min_overlap);
      for (int i = lane; i < 6 * n_new; i += 32) {
        const int c = nth(cand, i / 6), lvl = (i % 6) >> 1, side = i & 1;
        const int j = clampi(lower2 + lvl - 1 - CK, 0, NC - 1);
        const int* ch = cur(c >> 2) + kScal;
        int lo = ch[2 * side * NC + j], hi = ch[(2 * side + 1) * NC + j];
        if (!cf.SLAB || lo <= hi) lf_side(ix, side, (c & 3) + 1, lo, hi);
        int* E = cnd(c) + 4 * lvl;
        E[2 * side] = lo;
        E[2 * side + 1] = hi;
      }
      __syncwarp();
      int maxf[3];
#pragma unroll
      for (int lvl = 0; lvl < 3; ++lvl) {
        int v = 0;
#pragma unroll
        for (int r = 0; r < NW; ++r) {
          const int c = 32 * r + lane;
          if (c < C && ((cand[r] >> lane) & 1)) {
            const int* E = cnd(c) + 4 * lvl;
            v = max(v, isize(E[0], E[1]) + isize(E[2], E[3]));
          }
        }
        maxf[lvl] = warp_max(v);
      }
      const int rs2 = select_freqs(K, maxf, lower2, cur_k_new);
      const int pick = rs2 - lower2;
      const bool in = pick >= 0 && pick < 3;
#pragma unroll
      for (int r = 0; r < NW; ++r) {
        const int c = 32 * r + lane;
        if (c < C && ((cand[r] >> lane) & 1)) {
          int* X = cnd(c);
          for (int q = 0; q < 4; ++q) X[C_CI + q] = in ? X[4 * pick + q] : 0;
        }
      }
      cur_k_new = rs2;
      __syncwarp();
    }

    // PrunedBySeedSupport + computeErrorRate + isTerminated, per candidate
    const int curr_seed_idx = cur_len_new - SS;
    const int indel_off = SS + max_indel;
    const int small_idx = curr_seed_idx <= indel_off ? 0 : curr_seed_idx - indel_off;
    const int large_idx = min(curr_seed_idx + indel_off, q_len - SS);
    const int n_app = gerr_n + 1;
    const int slot_w = floormod(n_app - 1, cf.RING), slot_r = floormod(n_app, cf.RING);
    const double red_hit = K.redeem[0], red_miss = K.redeem[1], eb = *K.err_bound;
    const bool may_term = success && !no_term && cur_len_new >= min_length;
    // the parents of the candidates, as a leaf mask (round r holds the
    // candidates of leaves 8r..8r+7)
    unsigned cand_leaves = 0;
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int c = 32 * r + lane;
      if (c < C && ((cand[r] >> lane) & 1)) {
        cnd(c)[C_KEY] = -1;  // no match: the largest key
        cnd(c)[C_IMAX] = -1;
      }
      for (int x = 0; x < 8; ++x)
        if ((cand[r] >> (4 * x)) & 0xF) cand_leaves |= 1u << (8 * r + x);
    }
    for (int r = lane; r < cf.RMAX; r += 32) src()[r] = -1;
    __syncwarp();
    // the seed matches: one scan of the query window, each hit keyed
    // (|pos - currSeedIdx|, pos) into its candidate's least key
    {
      const int* q9 = K.qcode9 + (size_t)t * cf.QMAX;
      const int hi = min(large_idx, cf.QMAX - 1);
      for (int p = max(small_idx, 0) + lane; p <= hi; p += 32) {
        const int q = __ldg(q9 + p), b = (q & 7) - 1;
        if (q < 0 || b < 0 || b > 3) continue;
        for (unsigned m = cand_leaves; m; m &= m - 1) {
          const int l = __ffs(m) - 1, c = 4 * l + b;
          if (!bit(cand, c)) continue;
          const int* r = cur(l);
          const int last_ovl = r[F_LOVL], gap_len = cur_len_new - last_ovl;
          if (!(gap_len > SS || gap_len <= 1)) continue;
          const int sio_q = last_ovl < cur_len_new - SS ? SS : cur_len_new - last_ovl;
          if (p < r[F_LSEED] + sio_q) continue;
          const int* X = cnd(c) + C_CI;
          if (!(X[0] <= X[1] || X[2] <= X[3])) continue;
          if ((q >> 3) != (r[F_T9] & 0xFFFFFF)) continue;
          const unsigned key = ((unsigned)abs(p - curr_seed_idx) << 16) | (unsigned)p;
          atomicMin(reinterpret_cast<unsigned*>(cnd(c) + C_KEY), key);
        }
      }
    }
    __syncwarp();
    unsigned surv[NW];
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int c = 32 * r + lane;
      bool s = false;
      if (c < C && ((cand[r] >> lane) & 1)) {
        const int* P = cur(c >> 2);
        int* X = cnd(c);
        int last_seed = P[F_LSEED], last_ovl = P[F_LOVL], total_seeds = P[F_TSEEDS];
        int num_err = P[F_NERR], sio = P[F_SIO];
        int qovl = P[F_QOVL] + 1, covl = P[F_COVL] + 1;
        double nrs = f64(P + F_NRS);
        const int gap_len = cur_len_new - last_ovl;
        const bool do_match = gap_len > SS || gap_len <= 1;
        const unsigned key = (unsigned)X[C_KEY];
        const bool found = key != 0xffffffffu;
        const int best_pos = (int)(key & 0xffffu);
        const int v = curr_seed_idx + sio - last_seed;
        // the host's num_redeem_seed adds, at most one a step
        if (found && v > SS) nrs = __dadd_rn(nrs, red_hit);
        if (do_match && !found) {
          if (floormod(v, SS) == 1) num_err += 1;
          else if (v > SS - 1) nrs = __dadd_rn(nrs, red_miss);
        }
        if (!do_match) nrs = __dadd_rn(nrs, red_miss);
        if (found) {
          sio = best_pos - curr_seed_idx;
          last_seed = best_pos;
          qovl = best_pos + SS;
          last_ovl = cur_len_new;
          covl = cur_len_new;
          total_seeds += 1;
        }
        // computeErrorRate (:638-664), term for term as the host computes it
        const double matched = __dadd_rn((double)(total_seeds + SS - 1), nrs);
        const double total = (double)covl;
        const double gerr = __ddiv_rn(__dsub_rn(total, matched), total);
        double local = gerr;
        if (n_app >= cf.RING) {
          const double old = ring(P)[slot_r], ring_n = (double)cf.RING;
          local = __ddiv_rn(__dsub_rn(__dmul_rn(gerr, total),
                                      __dmul_rn(old, __dsub_rn(total, ring_n))),
                            ring_n);
        }
        s = !(local > eb);
        X[N_LSEED] = last_seed;
        X[N_LOVL] = last_ovl;
        X[N_TSEEDS] = total_seeds;
        X[N_COVL] = covl;
        X[N_NERR] = num_err;
        X[N_SIO] = sio;
        X[N_QOVL] = qovl;
        X[N_RF] = P[F_RF];
        X[N_RS] = P[F_RS];
        f64(X + N_GERR) = gerr;
        f64(X + N_LOCAL) = local;
        f64(X + N_NRS) = nrs;
      }
      surv[r] = __ballot_sync(kFull, s);
    }
    const int n_surv = count(surv);
    __syncwarp();

    // isTerminated: containment in a terminal interval, window >= startt;
    // thread = window, the last window per candidate by atomicMax
    if (may_term) {
      const int nt = min(n_term, cf.TMAX);
      const int* tf = K.term_f + (size_t)t * cf.TMAX * 2;
      const int* tr = K.term_r + (size_t)t * cf.TMAX * 2;
      for (int ti = lane; ti < nt; ti += 32) {
        const int f0 = __ldg(tf + 2 * ti), f1 = __ldg(tf + 2 * ti + 1);
        const int r0 = __ldg(tr + 2 * ti), r1 = __ldg(tr + 2 * ti + 1);
        for (int k = 0; k < n_surv; ++k) {
          int* X = cnd(nth(surv, k));
          if (ti < max(X[N_RS], 0)) continue;
          const int* I = X + C_CI;
          const bool cf_ = I[0] <= I[1] && I[0] >= f0 && I[1] <= f1;
          const bool cr_ = I[2] <= I[3] && I[2] >= r0 && I[3] <= r1;
          if (cf_ || cr_) atomicMax(X + C_IMAX, ti);
        }
      }
      __syncwarp();
    }

    // result slots: new ones in candidate order, the last writer (largest
    // candidate) of each slot wins
    int n_newres = 0;
    bool any_over = false;
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int c = 32 * r + lane;
      int* X = cnd(c);
      const bool tf = may_term && ((surv[r] >> lane) & 1) && X[C_IMAX] >= 0;
      const bool fresh = tf && X[N_RF] == -1;
      const unsigned w = __ballot_sync(kFull, fresh);
      const int slot = fresh ? res_count + n_newres + __popc(w & lt) : (tf ? X[N_RF] - 1 : -1);
      n_newres += __popc(w);
      any_over |= __any_sync(kFull, tf && slot >= cf.RMAX);
      if (tf) {
        if (slot >= 0 && slot < cf.RMAX) atomicMax(src() + slot, c);
        if (X[N_RF] == -1) X[N_RF] = slot + 1;
        X[N_RS] = X[C_IMAX];
      }
    }
    __syncwarp();
    for (int r = lane; r < cf.RMAX; r += 32) {
      const int c = src()[r];
      if (c < 0) continue;
      const int* X = cnd(c);
      res_len()[r] = cur_len_new;
      res_err()[r] = f64(X + N_GERR);
      res_i()[r] = X[C_IMAX];
      res_ref()[r] = (cur_len_new << 16) | ((c >> 2) << 8) | ((c & 3) + 1);
    }
    const bool walk_tie = tieA || (tieBC && need_l1);
    const int res_count_new = res_count + n_newres;

    // compact survivors into leaf slots, in candidate order
    const int nleaf = min(n_surv, L);
    {
      int before = 0;
#pragma unroll
      for (int r = 0; r < NW; ++r) {
        const int k = before + __popc(surv[r] & lt);
        if (((surv[r] >> lane) & 1) && k < L) lsrc()[k] = 32 * r + lane;
        before += __popc(surv[r]);
      }
    }
    __syncwarp();

    // the new leaves, each into its slot's other record: the scalars and
    // the label position (thread = leaf), the chain ring (thread = leaf,
    // level, side: slot j >= 1 = parent slot j-1 extended by the leaf's
    // char, slot 0 from the ck-mer cache of the new tail), the error ring
    const int ckmask = (1 << (2 * CK)) - 1;
    if (lane < nleaf) {
      const int c = lsrc()[lane], ch = (c & 3) + 1;
      const int* P = cur(c >> 2);
      const int* X = cnd(c);
      int* D = nxt(lane);
      for (int q = 0; q < 5; ++q) D[F_FLO + q] = X[C_CI + q];
      D[F_TOTK] = P[F_TOTK] + X[C_CI + 4];
      D[F_LSEED] = X[N_LSEED];
      D[F_LOVL] = X[N_LOVL];
      D[F_TSEEDS] = X[N_TSEEDS];
      D[F_COVL] = X[N_COVL];
      D[F_NERR] = X[N_NERR];
      D[F_SIO] = X[N_SIO];
      D[F_QOVL] = X[N_QOVL];
      D[F_RF] = X[N_RF];
      D[F_RS] = X[N_RS];
      D[F_TLET] = ch;
      D[F_TCNT] = P[F_TLET] == ch ? P[F_TCNT] + 1 : 1;
      D[F_T9] = ((P[F_T9] << 3) | ch) & ((1 << 27) - 1);
      D[F_T8] = ((P[F_T8] << 2) | (ch - 1)) & ckmask;
      f64(D + F_LERR) = f64(X + N_LOCAL);
      f64(D + F_GLAST) = f64(X + N_GERR);
      f64(D + F_NRS) = f64(X + N_NRS);
      D[F_LEN] = cur_len_new;
      if (cur_len_new - 1 < cf.MAXLEN)
        hist()[(cur_len_new - 1) * L + lane] = (uint8_t)(ch | ((c >> 2) << 3));
    }
    for (int i = lane; i < nleaf * 2 * NC; i += 32) {
      const int l = i / (2 * NC), j = (i % (2 * NC)) >> 1, side = i & 1;
      const int c = lsrc()[l], ch = (c & 3) + 1;
      const int* P = cur(c >> 2);
      int a, z;
      if (j == 0) {
        const int code8 = ((P[F_T8] << 2) | (ch - 1)) & ckmask;
        a = __ldg(ix.wcache + (size_t)code8 * 4 + 2 * side);
        z = __ldg(ix.wcache + (size_t)code8 * 4 + 2 * side + 1);
      } else {
        a = P[kScal + 2 * side * NC + j - 1];
        z = P[kScal + (2 * side + 1) * NC + j - 1];
        if (cf.SLAB && a > z) {
          a = 0;
          z = -1;
        } else {
          lf_side(ix, side, ch, a, z);
        }
      }
      int* D = nxt(l) + kScal;
      D[2 * side * NC + j] = a;
      D[(2 * side + 1) * NC + j] = z;
    }
    const int RV = (cf.RING + 1) >> 1;  // double2 vectors of a ring
    for (int i = lane; i < nleaf * RV; i += 32) {
      const int l = i / RV, v = i % RV, c = lsrc()[l];
      double2 x = reinterpret_cast<const double2*>(ring(cur(c >> 2)))[v];
      if ((slot_w >> 1) == v) {
        const double g = f64(cnd(c) + N_GERR);
        if (slot_w & 1)
          x.y = g;
        else
          x.x = g;
      }
      reinterpret_cast<double2*>(ring(nxt(l)))[v] = x;
    }
    __syncwarp();
    owner ^= low_mask(nleaf);
    alive = low_mask(nleaf);

    // >maxLeaves: the reference's while-condition exit (-3, or 1 with
    // results); n_surv > L below it: re-run in the wide config (-200)
    if (n_surv > cf.MAXLEAVES) code = res_count_new > 0 ? 1 : -3;
    else if (n_surv > L) code = -200;
    cur_len = cur_len_new;
    cur_k = cur_k_new;
    if (success) gerr_n = n_app;
    res_count = res_count_new;
    overflow = overflow || any_over;
    tie = tie || walk_tie;
  }

  // the label of length n whose last position was written into slot l,
  // from the history, into dst[0, n)
  __device__ __forceinline__ void label_to(int8_t* dst, int n, int l) const {
    const uint8_t* h = hist();
    for (int pos = n - 1; pos >= 0; --pos) {
      const int x = h[pos * cf.L + l];
      dst[pos] = (int8_t)(x & 7);
      l = x >> 3;
    }
  }
  // the label of result ref (length n, parent slot, last char)
  __device__ __forceinline__ void result_to(int8_t* dst, int ref) const {
    const int n = ref >> 16;
    if (n - 1 < cf.MAXLEN) dst[n - 1] = (int8_t)(ref & 0xff);
    label_to(dst, min(n - 1, cf.MAXLEN), (ref >> 8) & 0xff);
  }

  // the first slot with the least error below 1.0 (-1: none) among n
  __device__ __forceinline__ int best_result(const double* err, int n) const {
    double be = 2.0;
    int best = -1;
    for (int base = 0; base < cf.RMAX; base += 32) {
      const int r = base + lane;
      const double e = r < n ? err[r] : 2.0;
      const double v = e < 1.0 ? e : 2.0;
      const double m = warp_min(v);
      if (m < be) {
        be = m;
        best = base + __ffs(__ballot_sync(kFull, v == m)) - 1;
      }
    }
    return best;
  }

  // _reduce_results of the lane whose state is in S at row g into R row out
  __device__ __forceinline__ void reduce_state(const State& S, int g, const Reduced& R, int out) const {
    const size_t gr = (size_t)g * cf.RMAX;
    int best = best_result(S.res_err + gr, min(S.res_count[g], cf.RMAX));
    const bool has = best >= 0;
    if (!has) best = 0;
    const int8_t* from = S.res_labels + (gr + best) * cf.MAXLEN;
    int8_t* to = R.lab + (size_t)out * cf.MAXLEN;
    for (int m = lane; m < cf.MAXLEN; m += 32) to[m] = from[m];
    if (lane == 0) {
      R.code[out] = S.code[g];
      R.overflow[out] = S.res_overflow[g];
      R.tie[out] = S.res_tie[g];
      R.has[out] = has;
      R.len[out] = S.res_len[gr + best];
      R.i[out] = S.res_i[gr + best];
    }
  }

  // _reduce_results of the lane in shared memory into R row out (every
  // result row was all PAD before its label was written)
  __device__ __forceinline__ void reduce_smem(const Reduced& R, int out) const {
    int best = best_result(res_err(), min(res_count, cf.RMAX));
    const bool has = best >= 0;
    if (!has) best = 0;
    const int ref = res_ref()[best], n = min(ref >> 16, cf.MAXLEN);
    int8_t* to = R.lab + (size_t)out * cf.MAXLEN;
    for (int m = n + lane; m < cf.MAXLEN; m += 32) to[m] = (int8_t)kPad;
    if (lane == 0) {
      if (ref) result_to(to, ref);
      R.code[out] = code;
      R.overflow[out] = overflow;
      R.tie[out] = tie;
      R.has[out] = has;
      R.len[out] = res_len()[best];
      R.i[out] = res_i()[best];
    }
  }

  // the lane state of WalkState row g into shared memory; the loaded
  // labels become history positions [0, cur_len) whose parent is their slot
  __device__ __forceinline__ void load(const State& S, int g) {
    const int L = cf.L, NC = cf.NC;
    const size_t gl = (size_t)g * L;
    active = S.active[g];
    code = S.code[g];
    cur_len = S.cur_len[g];
    cur_k = S.cur_k[g];
    gerr_n = S.gerr_n[g];
    res_count = S.res_count[g];
    overflow = S.res_overflow[g];
    tie = S.res_tie[g];
    alive = __ballot_sync(kFull, lane < L && S.alive[gl + lane]);
    owner = 0;
    const int base_len = clampi(cur_len, 0, cf.MAXLEN);
    if (lane < L) {
      const size_t x = gl + lane;
      int* D = rec(0, lane);
      D[F_FLO] = S.f_lo[x];
      D[F_FHI] = S.f_hi[x];
      D[F_RLO] = S.r_lo[x];
      D[F_RHI] = S.r_hi[x];
      D[F_KFREQ] = S.kmer_freq[x];
      D[F_TOTK] = S.total_kmer[x];
      D[F_LSEED] = S.last_seed_idx[x];
      D[F_LOVL] = S.last_overlap_len[x];
      D[F_TSEEDS] = S.total_seeds[x];
      D[F_COVL] = S.curr_overlap_len[x];
      D[F_NERR] = S.num_errors[x];
      D[F_SIO] = S.seed_idx_offset[x];
      D[F_QOVL] = S.query_overlap_len[x];
      D[F_RF] = S.res_first[x];
      D[F_RS] = S.res_second[x];
      D[F_TLET] = S.tail_letter[x];
      D[F_TCNT] = S.tail_count[x];
      D[F_T9] = S.tail9[x];
      D[F_T8] = S.tail8[x];
      f64(D + F_LERR) = S.local_err[x];
      f64(D + F_GLAST) = S.gerr_last[x];
      f64(D + F_NRS) = S.nrs[x];
      D[F_LEN] = base_len;
    }
    for (int i = lane; i < L * 4 * NC; i += 32)
      rec(0, i / (4 * NC))[kScal + i % (4 * NC)] = S.chain[gl * 4 * NC + i];
    for (int i = lane; i < L * cf.RING; i += 32)
      ring(rec(0, i / cf.RING))[i % cf.RING] = S.ring[gl * cf.RING + i];
    for (int i = lane; i < L * base_len; i += 32) {
      const int l = i / base_len, pos = i % base_len;
      hist()[pos * L + l] = (uint8_t)((S.labels[(gl + l) * cf.MAXLEN + pos] & 7) | (l << 3));
    }
    const size_t gr = (size_t)g * cf.RMAX;
    for (int r = lane; r < cf.RMAX; r += 32) {
      res_len()[r] = S.res_len[gr + r];
      res_err()[r] = S.res_err[gr + r];
      res_i()[r] = S.res_i[gr + r];
      res_ref()[r] = 0;
    }
    __syncwarp();
  }

  // the lane state back into WalkState row g: every leaf slot's current
  // record, its label (positions [0, its length)), the result slots and
  // the labels of those written since the load
  __device__ __forceinline__ void store(const State& S, int g) const {
    const int L = cf.L, NC = cf.NC;
    const size_t gl = (size_t)g * L;
    if (lane < L) {
      const size_t x = gl + lane;
      const int* D = cur(lane);
      S.f_lo[x] = D[F_FLO];
      S.f_hi[x] = D[F_FHI];
      S.r_lo[x] = D[F_RLO];
      S.r_hi[x] = D[F_RHI];
      S.alive[x] = (alive >> lane) & 1;
      S.kmer_freq[x] = D[F_KFREQ];
      S.total_kmer[x] = D[F_TOTK];
      S.last_seed_idx[x] = D[F_LSEED];
      S.last_overlap_len[x] = D[F_LOVL];
      S.total_seeds[x] = D[F_TSEEDS];
      S.curr_overlap_len[x] = D[F_COVL];
      S.num_errors[x] = D[F_NERR];
      S.seed_idx_offset[x] = D[F_SIO];
      S.query_overlap_len[x] = D[F_QOVL];
      S.nrs[x] = f64(D + F_NRS);
      S.res_first[x] = D[F_RF];
      S.res_second[x] = D[F_RS];
      S.tail_letter[x] = (int8_t)D[F_TLET];
      S.tail_count[x] = D[F_TCNT];
      S.tail9[x] = D[F_T9];
      S.tail8[x] = D[F_T8];
      S.local_err[x] = f64(D + F_LERR);
      S.gerr_last[x] = f64(D + F_GLAST);
      label_to(S.labels + x * cf.MAXLEN, min(D[F_LEN], cf.MAXLEN), lane);
    }
    for (int i = lane; i < L * 4 * NC; i += 32)
      S.chain[gl * 4 * NC + i] = cur(i / (4 * NC))[kScal + i % (4 * NC)];
    for (int i = lane; i < L * cf.RING; i += 32)
      S.ring[gl * cf.RING + i] = ring(cur(i / cf.RING))[i % cf.RING];
    const size_t gr = (size_t)g * cf.RMAX;
    for (int r = lane; r < cf.RMAX; r += 32) {
      S.res_len[gr + r] = res_len()[r];
      S.res_err[gr + r] = res_err()[r];
      S.res_i[gr + r] = res_i()[r];
      if (res_ref()[r]) result_to(S.res_labels + (gr + r) * cf.MAXLEN, res_ref()[r]);
    }
    if (lane == 0) {
      S.code[g] = code;
      S.cur_len[g] = cur_len;
      S.cur_k[g] = cur_k;
      S.gerr_n[g] = gerr_n;
      S.res_count[g] = res_count;
      S.res_overflow[g] = overflow;
      S.res_tie[g] = tie;
    }
    __syncwarp();
  }

  // _init_state of one lane from task row t, in shared memory
  __device__ __forceinline__ void seed(const Root& RT) {
    const int L = cf.L, NC = cf.NC;
    const int ik = K.init_k[t];
    active = true;
    code = 0;
    cur_len = cur_k = ik;
    gerr_n = 1;
    res_count = 0;
    overflow = tie = false;
    alive = 1u;
    owner = 0;
    const int base_len = clampi(ik, 0, cf.MAXLEN);
    if (lane < L) {
      const bool u = lane == 0;
      int* D = rec(0, lane);
      D[F_FLO] = u ? RT.f_lo[t] : 0;
      D[F_FHI] = u ? RT.f_hi[t] : -1;
      D[F_RLO] = u ? RT.r_lo[t] : 0;
      D[F_RHI] = u ? RT.r_hi[t] : -1;
      D[F_KFREQ] = u ? RT.freq[t] : 0;
      D[F_TOTK] = 0;
      D[F_LSEED] = u ? ik - cf.SS : 0;
      D[F_LOVL] = u ? ik : 0;
      D[F_TSEEDS] = u ? ik - cf.SS + 1 : 0;
      D[F_COVL] = u ? ik : 0;
      D[F_NERR] = 0;
      D[F_SIO] = 0;
      D[F_QOVL] = u ? ik : 0;
      D[F_RF] = -1;
      D[F_RS] = -1;
      D[F_TLET] = u ? RT.tail_letter[t] : 0;
      D[F_TCNT] = u ? RT.tail_count[t] : 0;
      D[F_T9] = u ? RT.tail9[t] : 0;
      D[F_T8] = u ? RT.tail8[t] : 0;
      f64(D + F_LERR) = 0.0;
      f64(D + F_GLAST) = 0.0;
      f64(D + F_NRS) = 0.0;
      D[F_LEN] = base_len;
    }
    for (int i = lane; i < L * 4 * NC; i += 32) {
      const int l = i / (4 * NC), k = i % (4 * NC);
      rec(0, l)[kScal + k] = l == 0 ? RT.chain0[(size_t)t * 4 * NC + k] : ((k / NC) & 1 ? -1 : 0);
    }
    for (int i = lane; i < L * cf.RING; i += 32) ring(rec(0, i / cf.RING))[i % cf.RING] = 0.0;
    const int8_t* q = K.query + (size_t)t * cf.QMAX;
    for (int i = lane; i < L * base_len; i += 32) {
      const int l = i / base_len, pos = i % base_len;
      const int s = (l == 0 && pos < cf.QMAX) ? q[pos] : kPad;
      hist()[pos * L + l] = (uint8_t)((s & 7) | (l << 3));
    }
    for (int r = lane; r < cf.RMAX; r += 32) {
      res_len()[r] = 0;
      res_err()[r] = 0.0;
      res_i()[r] = 0;
      res_ref()[r] = 0;
    }
    __syncwarp();
  }
};

// ---------------------------------------------------------------------------
// prep (_prep_core) of one task, by one warp
// ---------------------------------------------------------------------------
//
// A task's outputs: the qcode9/qcode5 rows, the tails, and the intervals of
// up to TMAX terminal windows, NC chain-ring slots and the root, each one
// ladder of LF steps.  A window m >= n_term and a slot CK + i > init_k only
// give constants (1/0 and 0/-1), so their ladders are not run.  The root is
// the ladder of slot init_k - CK (both read query[0:n] from position 0,
// with the same n) whenever that slot exists, so it is taken from there.
// The remaining ladders (at most n_term + init_k - CK + 2) go one to a
// lane; the query and target rows are staged in shared memory first.
// A ladder of n >= CK symbols starts from the ck-mer interval table
// (wcache) at level CK, also where the JAX batch prep (use_wcache = 0)
// climbs from level 1: both are the same LF steps over the same ACGT
// symbols (the table is built by them), so the interval is the same.

struct PrepOut {
  int *qcode9, *qcode5, *term_f, *term_r, *f_lo, *f_hi, *r_lo, *r_hi, *freq, *chain0,
      *tail9, *tail8;
  int8_t* tail_letter;
  int* tail_count;
};

struct PrepIn {
  const int8_t* query;
  const int* q_len;
  const int8_t* trg;
  const int* n_term;
  const int* init_k;
  const int* min_overlap;
  int QMAX, TMAX, KMAX, CK, SS, kb_term, kb_root, use_wcache;
  int table;  // the wcache holds every CK-mer
  int parts;  // PREP_* bits: the parts of the prep a launch runs (timing variants)
};

constexpr int PREP_CODES = 1, PREP_TERM = 2, PREP_CHAIN = 4, PREP_ALL = 7;

// the shared-memory bytes of one task's staged rows (16-byte multiple)
__device__ __host__ __forceinline__ int prep_row_bytes(int QMAX, int TMAX, int KMAX) {
  return (QMAX + TMAX + KMAX + 15) & ~15;
}

// the interval of the n >= 1 symbols src[off + j], j < n (the index
// clamped into [0, lim], each symbol into 1..4), appended left to right.
// One copy of this code serves windows, slots and the root: a copy inlined
// for each kind made the launch several times slower (PERF.md)
__device__ __forceinline__ void prep_ladder(const Index& ix, const PrepIn& P, const int8_t* src,
                                            int off, int lim, int n, int* st) {
  auto sym = [&](int j) { return clampi((int)src[clampi(off + j, 0, lim)], 1, 4); };
  int from = 1;
  if (P.table && n >= P.CK) {
    int code = 0;
    for (int j = 0; j < P.CK; ++j) code = (code << 2) | (sym(j) - 1);
    wcache_get(ix, code, st);
    from = P.CK;
  } else {
    init_bi(ix, sym(0), st);
  }
  for (int j = from; j < n; ++j) extend_bi(ix, sym(j), st);
}

__device__ void prep_task(const Index& ix, const PrepIn& P, const PrepOut& O, int t, int lane,
                          int8_t* sq) {
  const int QMAX = P.QMAX, TMAX = P.TMAX, CK = P.CK, NC = P.KMAX - P.CK + 1;
  const int TW = TMAX + P.KMAX;
  const int ckmask = (1 << (2 * CK)) - 1;
  int8_t* st_ = sq + QMAX;  // the target row
  const int8_t* q = P.query + (size_t)t * QMAX;
  if ((QMAX & 15) == 0) {
    for (int i = lane; i < QMAX / 16; i += 32)
      reinterpret_cast<int4*>(sq)[i] = __ldg(reinterpret_cast<const int4*>(q) + i);
  } else {
    for (int i = lane; i < QMAX; i += 32) sq[i] = q[i];
  }
  for (int i = lane; i < TW; i += 32) st_[i] = P.trg[(size_t)t * TW + i];
  __syncwarp();
  const int qlen = P.q_len[t], ik = P.init_k[t], mo = P.min_overlap[t];
  const int nt = clampi(P.n_term[t], 0, TMAX);  // windows that are kept
  const int nc = clampi(ik - CK + 1, 0, NC);    // chain slots that are kept
  auto qc = [&](int p) { return p < QMAX ? (int)sq[p] : kPad; };
  int* tf = O.term_f + (size_t)t * TMAX * 2;
  int* tr = O.term_r + (size_t)t * TMAX * 2;
  int* c0 = O.chain0 + (size_t)t * 4 * NC;

  if (P.parts & PREP_CODES) {
    // qcode9 / qcode5 rows
    for (int p = lane; p < QMAX; p += 32) {
      int c9 = 0, c5 = 0;
      for (int j = 0; j < P.SS; ++j) c9 = (c9 << 3) | qc(p + j);
      for (int j = 0; j < 5; ++j) c5 = (c5 << 3) | qc(p + j);
      O.qcode9[(size_t)t * QMAX + p] = p < qlen - P.SS + 1 ? c9 : -1;
      O.qcode5[(size_t)t * QMAX + p] = p < qlen - 5 + 1 ? c5 : -1;
    }
    // the skipped ladders' constants
    for (int m = nt + lane; m < TMAX; m += 32) {
      tf[2 * m] = 1;
      tf[2 * m + 1] = 0;
      tr[2 * m] = 1;
      tr[2 * m + 1] = 0;
    }
    for (int i = nc + lane; i < NC; i += 32) {
      c0[i] = 0;
      c0[NC + i] = -1;
      c0[2 * NC + i] = 0;
      c0[3 * NC + i] = -1;
    }
    if (lane == 0) {
      // tail metadata
      int t9 = 0, t8 = 0;
      for (int i = 0; i < P.SS; ++i) {
        const int pos = ik - P.SS + i;
        if (pos >= 0) t9 = (t9 << 3) | (int)sq[clampi(pos, 0, QMAX - 1)];
      }
      for (int i = 0; i < CK; ++i) {
        const int pos = ik - CK + i;
        if (pos >= 0) t8 = ((t8 << 2) | ((int)sq[clampi(pos, 0, QMAX - 1)] - 1)) & ckmask;
      }
      O.tail9[t] = t9;
      O.tail8[t] = t8;
      const int last = sq[clampi(ik - 1, 0, QMAX - 1)];
      O.tail_letter[t] = (int8_t)last;
      int cnt = 0;
      for (int i = 0; i < P.KMAX; ++i) {
        const int b = ik - 1 - i;
        if (b < 0 || (int)sq[clampi(b, 0, QMAX - 1)] != last) break;
        ++cnt;
      }
      O.tail_count[t] = cnt;
    }
  }

  // the ladders' lengths, as the JAX prep's loops run them: from level CK
  // (use_wcache) or 1 up to kb_term / kb_root, stopping at the task's own
  // min_overlap / slot length / init_k
  const int lo_len = P.use_wcache ? CK : 1;
  const int term_n = max(lo_len, min(P.kb_term, mo));
  auto chain_n = [&](int i) { return min(max(P.kb_root, CK), CK + i); };
  const int root_n = max(lo_len, min(P.kb_root, ik));
  const bool reuse = ik >= CK && ik - CK < NC && root_n == chain_n(ik - CK);
  const int n_slot = (P.parts & PREP_CHAIN) ? nc : 0;
  const int n_chain = (P.parts & PREP_CHAIN) ? nc + (reuse ? 0 : 1) : 0;
  const int n_items = n_chain + ((P.parts & PREP_TERM) ? nt : 0);
  for (int it = lane; it < n_items; it += 32) {
    // chain slot i (the suffix of query[0:init_k] of length CK + i), the
    // root (where no slot holds it), or terminal window m (trg[m : ...])
    const bool slot = it < n_slot, window = it >= n_chain;
    const int m = it - n_chain;
    int st[4];
    prep_ladder(ix, P, window ? st_ : sq, slot ? ik - (CK + it) : window ? m : 0,
                window ? TW - 1 : QMAX - 1, slot ? chain_n(it) : window ? term_n : root_n, st);
    if (slot) {
      c0[it] = st[0];
      c0[NC + it] = st[1];
      c0[2 * NC + it] = st[2];
      c0[3 * NC + it] = st[3];
      if (!reuse || it != ik - CK) continue;
    } else if (window) {
      tf[2 * m] = st[0];
      tf[2 * m + 1] = st[1];
      tr[2 * m] = st[2];
      tr[2 * m + 1] = st[3];
      continue;
    }
    O.f_lo[t] = st[0];
    O.f_hi[t] = st[1];
    O.r_lo[t] = st[2];
    O.r_hi[t] = st[3];
    O.freq[t] = isize(st[0], st[1]) + isize(st[2], st[3]);
  }
}

}  // namespace walk
}  // namespace lrsc
