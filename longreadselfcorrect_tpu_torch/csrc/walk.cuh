// The FM-extension walk of one gap lane, as __device__ functions shared by
// the four kernels of walk.cu.
//
// Replaces the JAX package's ops/walk.py superstep (:997-1593) with its
// helpers (:691-978), _reduce_results (:1600), the lane seeding of
// _init_state (:521) and the per-task prep of _prep_core (:371-518).
//
// One thread walks one gap lane: it reads the lane's WalkState (global
// memory, laid out [G, ...] as the torch tensors), runs the superstep's
// vectorised JAX expressions as loops over the lane's L leaves and 4L
// candidates, and writes the state back.  Lanes never interact.  Every
// value is the JAX one bit for bit: the same integer formulas, the same
// tie-breaks (first argmin, last writer per result slot, candidate order
// in the leaf compaction), and the f32 error rates with the two fused
// multiply-adds and the reciprocal multiply that XLA compiles into the
// JAX function (__fmaf_rn / __fmul_rn; the file is built with -fmad=false
// so nothing else is contracted).
//
// Rank queries go through rank.cuh directly: where the JAX slab engine
// (SLAB configs) reads a rank off a block slab, every such query lies in
// the slab, so the value is the direct rank; only the slab span test and
// its -300 escape, and the slab path's (0, -1) for empty intervals, stay.
//
// The label, ring and chain buffers of the new leaves are written to a
// per-lane scratch row while the parents' are read, then copied back.
#pragma once

#include <cstdint>

#include "rank.cuh"

namespace lrsc {
namespace walk {

constexpr int kPad = 5;

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
  const float* pacbio_e;
  const float* err_bound;
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
      *curr_overlap_len, *num_errors, *seed_idx_offset, *query_overlap_len, *red_a,
      *red_b, *res_first, *res_second;
  int8_t* tail_letter;
  int *tail_count, *tail9, *tail8, *chain;
  float *local_err, *gerr_last, *ring;
  bool* active;
  int *cur_len, *cur_k, *gerr_n, *code;
  int8_t* res_labels;
  int* res_len;
  float* res_err;
  int *res_i, *res_count;
  bool* res_overflow;
};

struct Reduced {
  int* code;
  bool* overflow;
  bool* has;
  int8_t* lab;
  int* len;
  int* i;
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

// the walk-convention bi-interval extension (rank.extend_bi): append sym
__device__ __forceinline__ void extend_bi(const Index& ix, int sym, int* st) {
  lf_f(ix, sym, st[0], st[1]);
  lf_r(ix, comp(sym), st[2], st[3]);
}
__device__ __forceinline__ void init_bi(const Index& ix, int sym, int* st) {
  st[0] = __ldg(ix.fC + sym);
  st[1] = __ldg(ix.fC + sym + 1) - 1;
  const int c = comp(sym);
  st[2] = __ldg(ix.rC + c);
  st[3] = __ldg(ix.rC + c + 1) - 1;
}
__device__ __forceinline__ void wcache_get(const Index& ix, int code, int* st) {
  for (int q = 0; q < 4; ++q) st[q] = __ldg(ix.wcache + (size_t)code * 4 + q);
}

// _probe4: the four 1-base extensions of one bi-interval; an invalid side
// keeps its interval.  out[q][b] for q in (f_lo, f_hi, r_lo, r_hi), and
// freq[b].
__device__ void probe4(const Index& ix, int flo, int fhi, int rlo, int rhi,
                       int out[4][4], int freq[4]) {
  const bool fv = flo <= fhi, rv = rlo <= rhi;
  for (int b = 0; b < 4; ++b) {
    int a = flo, z = fhi;
    if (fv) lf_f(ix, b + 1, a, z);
    out[0][b] = a;
    out[1][b] = z;
    int c = rlo, d = rhi;
    if (rv) lf_r(ix, 4 - b, c, d);
    out[2][b] = c;
    out[3][b] = d;
    freq[b] = isize(a, z) + isize(c, d);
  }
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

// SelectFreqsOfrange (:281-331); freq3[i][x] with mask[x], x < n
__device__ int select_freqs(const Consts& K, const int* f0, const int* f1,
                            const int* f2, const bool* mask, int n, int lower,
                            int upper) {
  const int* f3[3] = {f0, f1, f2};
  int rs = upper;
  bool decided = false;
  for (int i = 0; i < 3; ++i) {
    const int ln = lower + i;
    int maxf = 0;
    for (int x = 0; x < n; ++x)
      if (mask[x]) maxf = max(maxf, f3[i][x]);
    const int expected = (int)K.freqs[clampi(ln, 0, 100)];
    if (ln <= upper && maxf - expected < 5 && !decided) {
      rs = ln;
      decided = true;
    }
  }
  return rs;
}

template <int LM>
struct Lane {
  const Index& ix;
  const Cfg& cf;
  const Consts& K;
  const State& S;
  int g;  // lane
  int t;  // task row of the constants

  __device__ int chain_at(int l, int q, int j) const {
    return S.chain[(((size_t)g * cf.L + l) * 4 + q) * cf.NC + j];
  }

  // ismatchedbykmer (:787-821)
  __device__ bool match5(int code5, int cur_len, int max_indel) const {
    const int lo = max(cur_len - max_indel, 0), hi = min(cur_len + max_indel, cf.QMAX - 1);
    const int* row = K.qcode5 + (size_t)t * cf.QMAX;
    for (int p = lo; p <= hi; ++p) {
      const int c = row[p];
      if (c >= 0 && c == code5) return true;
    }
    return false;
  }

  // one attempt round over the L leaves (JAX `attempt` + _leaf_choice)
  __device__ bool attempt(const int (*p)[4][4], const int (*fq)[4], int thresh,
                          const bool* alive1, const bool* retry_ok,
                          const bool* tie_leaf, const int* tailc, const int* cand5,
                          int cur_len, int max_indel, bool (*ext)[4],
                          bool (*mt1)[4], bool (*m5)[4], int* tot, int* mx) const {
    bool haz = false;
    for (int l = 0; l < cf.L; ++l) {
      int total = 0, maxf = fq[l][0];
      for (int b = 0; b < 4; ++b) {
        total += fq[l][b];
        maxf = max(maxf, fq[l][b]);
      }
      tot[l] = total;
      mx[l] = maxf;
      bool mt[4], any_t = false, any_t1 = false;
      for (int b = 0; b < 4; ++b) {
        const bool pvalid = p[l][0][b] <= p[l][1][b] || p[l][2][b] <= p[l][3][b];
        m5[l][b] = pvalid && match5(cand5[l * 4 + b], cur_len, max_indel);
        mt[b] = cutoff(fq[l][b], total, maxf, m5[l][b], tailc[l], thresh);
        mt1[l][b] = cutoff(fq[l][b], total, maxf, m5[l][b], tailc[l], thresh - 1);
        any_t |= mt[b];
        any_t1 |= mt1[l][b];
      }
      for (int b = 0; b < 4; ++b)
        ext[l][b] = alive1[l] && (any_t ? mt[b] : (retry_ok[l] && mt1[l][b]));
      haz |= tie_leaf[l] && alive1[l] && !any_t && any_t1;
    }
    return haz;
  }

  // one superstep of this lane (JAX superstep)
  __device__ void step(int* scratch) const {
    const int L = cf.L, C = 4 * L, NC = cf.NC, SS = cf.SS, CK = cf.CK;
    const size_t gl = (size_t)g * L;
    bool* alive = S.alive + gl;
    const int max_length = K.max_length[t], max_overlap = K.max_overlap[t];
    const int min_overlap = K.min_overlap[t], min_sa = K.min_sa[t];
    const int max_indel = K.max_indel[t];
    int code = S.code[g];
    const int cur_len = S.cur_len[g];
    const int res_count = S.res_count[g];

    // while-condition on the state left by the last step
    int n_alive = 0;
    for (int l = 0; l < L; ++l) n_alive += alive[l];
    const bool cond_ok = n_alive > 0 && n_alive <= cf.MAXLEAVES && cur_len <= max_length;
    const bool gap_go = S.active[g] && code == 0;
    if (gap_go && !cond_ok) {
      if (res_count > 0) code = 1;
      else if (n_alive == 0) code = -1;
      else if (cur_len > max_length) code = -2;
      else code = -3;
    }
    if (!(gap_go && cond_ok)) {
      S.code[g] = code;
      return;
    }

    // slab escape: the slot-0 interval of every live leaf spans <= SB blocks
    if (cf.SLAB) {
      bool bad = false;
      for (int l = 0; l < L; ++l) {
        if (!alive[l]) continue;
        bool ok = true;
        for (int side = 0; side < 2; ++side) {
          const int lo0 = chain_at(l, 2 * side, 0), hi0 = chain_at(l, 2 * side + 1, 0);
          if (lo0 <= hi0 &&
              floordiv(hi0 + 1, kBlock) - floordiv(lo0, kBlock) + 1 > cf.SB)
            ok = false;
        }
        const bool inv_f = S.f_lo[gl + l] <= S.f_hi[gl + l] && chain_at(l, 0, 0) > chain_at(l, 1, 0);
        const bool inv_r = S.r_lo[gl + l] <= S.r_hi[gl + l] && chain_at(l, 2, 0) > chain_at(l, 3, 0);
        bad |= !ok || inv_f || inv_r;
      }
      if (bad) {
        S.code[g] = -300;
        return;
      }
    }

    // extendLeaves: the optional kmer-size clamp refine
    const int cur_k = S.cur_k[g];
    const bool need_ref0 = cur_k > max_overlap;
    const int jmo = clampi(max_overlap - CK, 0, NC - 1);
    int lf[LM][4];
    for (int l = 0; l < L; ++l) {
      const bool sel = need_ref0 && alive[l];
      lf[l][0] = sel ? chain_at(l, 0, jmo) : S.f_lo[gl + l];
      lf[l][1] = sel ? chain_at(l, 1, jmo) : S.f_hi[gl + l];
      lf[l][2] = sel ? chain_at(l, 2, jmo) : S.r_lo[gl + l];
      lf[l][3] = sel ? chain_at(l, 3, jmo) : S.r_hi[gl + l];
    }
    const int cur_k0 = need_ref0 ? max_overlap : cur_k;

    // attempToExtend: erase relatively bad leaves, retry eligibility
    float ev[LM];
    float min_err = 2.0f;
    for (int l = 0; l < L; ++l) {
      ev[l] = alive[l] ? S.local_err[gl + l] : 2.0f;
      if (ev[l] < min_err) min_err = ev[l];
    }
    bool alive1[LM], retry_ok[LM], tie_leaf[LM], is_min[LM];
    int leaf_cnt = 0, n_min_alive = 0;
    for (int l = 0; l < L; ++l) {
      const float diff = __fsub_rn(S.local_err[gl + l], min_err);
      const bool erase = alive[l] && ((diff > 0.05f && cur_len > cf.RING / 2) ||
                                      (diff > 0.1f && cur_len > 15));
      alive1[l] = alive[l] && !erase;
      leaf_cnt += alive1[l];
      is_min[l] = ev[l] == min_err;
      n_min_alive += is_min[l] && alive[l];
    }
    for (int l = 0; l < L; ++l) {
      retry_ok[l] = is_min[l] && leaf_cnt > 1;
      tie_leaf[l] = retry_ok[l] && n_min_alive > 1;
    }
    int cand5[4 * LM], tailc[LM];
    for (int l = 0; l < L; ++l) {
      tailc[l] = S.tail_count[gl + l];
      for (int b = 0; b < 4; ++b)
        cand5[l * 4 + b] = (((S.tail9[gl + l] << 3) | (b + 1)) & ((1 << 27) - 1)) &
                           ((1 << 15) - 1);
    }

    // level 0
    int p0[LM][4][4], q0[LM][4];
    const int j0 = clampi(cur_k0 - CK, 0, NC - 1);
    for (int l = 0; l < L; ++l) {
      if (cf.SLAB)
        probe4(ix, chain_at(l, 0, j0), chain_at(l, 1, j0), chain_at(l, 2, j0),
               chain_at(l, 3, j0), p0[l], q0[l]);
      else
        probe4(ix, lf[l][0], lf[l][1], lf[l][2], lf[l][3], p0[l], q0[l]);
    }
    bool extA[LM][4], mt1[LM][4], m5[LM][4];
    int tot[LM], mx[LM];
    const bool hazA = attempt(p0, q0, min_sa, alive1, retry_ok, tie_leaf, tailc,
                              cand5, cur_len, max_indel, extA, mt1, m5, tot, mx);
    bool gapA = false;
    for (int l = 0; l < L; ++l)
      for (int b = 0; b < 4; ++b) gapA |= extA[l][b];

    // level 1 (k reduce) + level 2 (threshold relax), only when needed
    const bool need_l1 = !gapA;
    int p1[LM][4][4], q1[LM][4];
    bool extB[LM][4], extC[LM][4];
    bool gapB = false, gapC = false, hazBC = false;
    int reduce_size = cur_k0;
    if (need_l1) {
      const int lower = max(cur_k0 - 2, min_overlap);
      int f3[3][LM];
      for (int i = 0; i < 3; ++i) {
        const int j = clampi(lower + i - CK, 0, NC - 1);
        for (int l = 0; l < L; ++l)
          f3[i][l] = isize(chain_at(l, 0, j), chain_at(l, 1, j)) +
                     isize(chain_at(l, 2, j), chain_at(l, 3, j));
      }
      reduce_size = select_freqs(K, f3[0], f3[1], f3[2], alive1, L, lower, cur_k0);
      const int j1 = clampi(reduce_size - CK, 0, NC - 1);
      for (int l = 0; l < L; ++l)
        probe4(ix, chain_at(l, 0, j1), chain_at(l, 1, j1), chain_at(l, 2, j1),
               chain_at(l, 3, j1), p1[l], q1[l]);
      const bool hazB = attempt(p1, q1, min_sa, alive1, retry_ok, tie_leaf, tailc,
                                cand5, cur_len, max_indel, extB, mt1, m5, tot, mx);
      bool hazC = false;
      for (int l = 0; l < L; ++l) {
        bool mt2[4], any_1 = false, any_2 = false;
        for (int b = 0; b < 4; ++b) {
          mt2[b] = cutoff(q1[l][b], tot[l], mx[l], m5[l][b], tailc[l], min_sa - 2);
          any_1 |= mt1[l][b];
          any_2 |= mt2[b];
        }
        for (int b = 0; b < 4; ++b) {
          extC[l][b] = alive1[l] && (any_1 ? mt1[l][b] : (retry_ok[l] && mt2[b]));
          gapB |= extB[l][b];
          gapC |= extC[l][b];
        }
        hazC |= tie_leaf[l] && alive1[l] && !any_1 && any_2;
      }
      gapC = gapC && !gapB;
      hazBC = hazB || hazC;
    }
    const bool use_l1 = need_l1 && (gapB || gapC);

    // candidates c = 4 * parent + (base - 1)
    int c_flo[4 * LM], c_fhi[4 * LM], c_rlo[4 * LM], c_rhi[4 * LM], c_freq[4 * LM];
    bool cand[4 * LM];
    bool success = false;
    for (int l = 0; l < L; ++l)
      for (int b = 0; b < 4; ++b) {
        const int c = l * 4 + b;
        const bool e = gapA ? extA[l][b] : gapB ? extB[l][b] : gapC ? extC[l][b] : false;
        cand[c] = e;
        success |= e;
        c_flo[c] = use_l1 ? p1[l][0][b] : p0[l][0][b];
        c_fhi[c] = use_l1 ? p1[l][1][b] : p0[l][1][b];
        c_rlo[c] = use_l1 ? p1[l][2][b] : p0[l][2][b];
        c_rhi[c] = use_l1 ? p1[l][3][b] : p0[l][3][b];
        c_freq[c] = use_l1 ? q1[l][b] : q0[l][b];
      }
    const int cur_k_base = use_l1 ? reduce_size : cur_k0;
    const int cur_len_new = success ? cur_len + 1 : cur_len;
    int cur_k_new = success ? cur_k_base + 1 : cur_k_base;

    // isInsufficientFreqs -> reduce + refine the candidates
    int high_cnt = 0, n_new = 0;
    for (int c = 0; c < C; ++c) {
      high_cnt += cand[c] && c_freq[c] > min_sa;
      n_new += cand[c];
    }
    const bool insuff = high_cnt == 0 || (high_cnt <= 2 && n_new >= 5) ||
                        (high_cnt <= 1 && n_new >= 3);
    if (success && insuff) {
      const int lower2 = max(cur_k_new - 2, min_overlap);
      int e3[3][4][4 * LM], fr3[3][4 * LM];
      for (int i = 0; i < 3; ++i) {
        const int j = clampi(lower2 + i - 1 - CK, 0, NC - 1);
        for (int c = 0; c < C; ++c) {
          fr3[i][c] = 0;
          if (!cand[c]) continue;
          const int l = c >> 2, ch = (c & 3) + 1;
          int a = chain_at(l, 0, j), z = chain_at(l, 1, j);
          int u = chain_at(l, 2, j), w = chain_at(l, 3, j);
          const bool fv = a <= z, rv = u <= w;
          if (!cf.SLAB || fv) lf_f(ix, ch, a, z);
          if (!cf.SLAB || rv) lf_r(ix, comp(ch), u, w);
          e3[i][0][c] = a;
          e3[i][1][c] = z;
          e3[i][2][c] = u;
          e3[i][3][c] = w;
          fr3[i][c] = isize(a, z) + isize(u, w);
        }
      }
      const int rs2 = select_freqs(K, fr3[0], fr3[1], fr3[2], cand, C, lower2, cur_k_new);
      const int pick = rs2 - lower2;
      for (int c = 0; c < C; ++c) {
        if (!cand[c]) continue;
        const bool in = pick >= 0 && pick < 3;
        c_flo[c] = in ? e3[pick][0][c] : 0;
        c_fhi[c] = in ? e3[pick][1][c] : 0;
        c_rlo[c] = in ? e3[pick][2][c] : 0;
        c_rhi[c] = in ? e3[pick][3][c] : 0;
      }
      cur_k_new = rs2;
    }

    // PrunedBySeedSupport + computeErrorRate + isTerminated, per candidate
    const int curr_seed_idx = cur_len_new - SS;
    const int indel_off = SS + max_indel;
    const int small_idx = curr_seed_idx <= indel_off ? 0 : curr_seed_idx - indel_off;
    const int large_idx = min(curr_seed_idx + indel_off, K.q_len[t] - SS);
    const int n_app = S.gerr_n[g] + 1;
    const int slot_w = floormod(n_app - 1, cf.RING), slot_r = floormod(n_app, cf.RING);
    const float pe = *K.pacbio_e, eb = *K.err_bound;
    const bool may_term = success && !K.no_term[t] && cur_len_new >= K.min_length[t];
    const int* q9 = K.qcode9 + (size_t)t * cf.QMAX;
    const int n_term = K.n_term[t];

    int c_last_seed[4 * LM], c_last_ovl[4 * LM], c_total_seeds[4 * LM],
        c_num_err[4 * LM], c_sio[4 * LM], c_red_a[4 * LM], c_red_b[4 * LM],
        c_qovl[4 * LM], c_covl[4 * LM], c_rf[4 * LM], c_rs[4 * LM], imax[4 * LM];
    float gerr[4 * LM], local[4 * LM];
    bool surv[4 * LM], t_found[4 * LM];
    int n_surv = 0, n_newres = 0, slot[4 * LM];
    bool any_over = false;
    for (int c = 0; c < C; ++c) {
      surv[c] = t_found[c] = false;
      slot[c] = -1;
      if (!cand[c]) continue;
      const size_t p = gl + (c >> 2);
      c_last_seed[c] = S.last_seed_idx[p];
      c_last_ovl[c] = S.last_overlap_len[p];
      c_total_seeds[c] = S.total_seeds[p];
      c_num_err[c] = S.num_errors[p];
      c_sio[c] = S.seed_idx_offset[p];
      c_red_a[c] = S.red_a[p];
      c_red_b[c] = S.red_b[p];
      c_qovl[c] = S.query_overlap_len[p] + 1;
      c_covl[c] = S.curr_overlap_len[p] + 1;
      c_rf[c] = S.res_first[p];
      c_rs[c] = S.res_second[p];

      const int gap_len = cur_len_new - c_last_ovl[c];
      const bool do_match = gap_len > SS || gap_len <= 1;
      const int sio_q = c_last_ovl[c] < cur_len_new - SS ? SS : cur_len_new - c_last_ovl[c];
      const int start_idx = max(small_idx, c_last_seed[c] + sio_q);
      const bool c_valid = c_flo[c] <= c_fhi[c] || c_rlo[c] <= c_rhi[c];
      const int code9 = ((S.tail9[p] << 3) | ((c & 3) + 1)) & ((1 << 27) - 1);
      bool found = false;
      int best_pos = 0, best_diff = 0;
      if (do_match && c_valid) {
        for (int pos = max(start_idx, 0); pos <= min(large_idx, cf.QMAX - 1); ++pos) {
          const int q = q9[pos];
          if (q < 0 || q != code9) continue;
          const int diff = abs(pos - curr_seed_idx);
          if (!found || diff < best_diff) {
            found = true;
            best_diff = diff;
            best_pos = pos;
          }
        }
      }
      const int v = curr_seed_idx + c_sio[c] - c_last_seed[c];
      if (found && v > SS) c_red_b[c] += 1;
      if (do_match && !found) {
        if (floormod(v, SS) == 1) c_num_err[c] += 1;
        else if (v > SS - 1) c_red_a[c] += 1;
      }
      if (!do_match) c_red_a[c] += 1;
      if (found) {
        c_sio[c] = best_pos - curr_seed_idx;
        c_last_seed[c] = best_pos;
        c_qovl[c] = best_pos + SS;
        c_last_ovl[c] = cur_len_new;
        c_covl[c] = cur_len_new;
        c_total_seeds[c] += 1;
      }
      const int U = c_covl[c] - c_total_seeds[c] - (SS - 1) - c_red_a[c];
      const int V = c_red_a[c] - (SS - 1) * c_red_b[c];
      const float total = (float)c_covl[c];
      gerr[c] = __fdiv_rn(__fmaf_rn((float)V, pe, (float)U), total);
      if (n_app >= cf.RING) {
        const float old = S.ring[p * cf.RING + slot_r];
        const float sub = __fmul_rn(old, __fsub_rn(total, (float)cf.RING));
        local[c] = __fmul_rn(__fmaf_rn(gerr[c], total, -sub),
                             __fdiv_rn(1.0f, (float)cf.RING));
      } else {
        local[c] = gerr[c];
      }
      surv[c] = !(local[c] > eb);
      n_surv += surv[c];
      if (!surv[c] || !may_term) continue;

      // isTerminated: containment in a terminal interval, window >= startt
      imax[c] = -1;
      const bool fv = c_flo[c] <= c_fhi[c], rv = c_rlo[c] <= c_rhi[c];
      const int* tf = K.term_f + (size_t)t * cf.TMAX * 2;
      const int* tr = K.term_r + (size_t)t * cf.TMAX * 2;
      for (int ti = max(c_rs[c], 0); ti < min(n_term, cf.TMAX); ++ti) {
        const bool cf_ = fv && c_flo[c] >= tf[2 * ti] && c_fhi[c] <= tf[2 * ti + 1];
        const bool cr_ = rv && c_rlo[c] >= tr[2 * ti] && c_rhi[c] <= tr[2 * ti + 1];
        if (cf_ || cr_) imax[c] = ti;
      }
      t_found[c] = imax[c] >= 0;
      if (!t_found[c]) continue;
      if (c_rf[c] == -1) {
        n_newres += 1;
        slot[c] = res_count + n_newres - 1;
      } else {
        slot[c] = c_rf[c] - 1;
      }
      any_over |= slot[c] >= cf.RMAX;
    }

    // result slots: the last writer (largest candidate) wins
    const size_t gr = (size_t)g * cf.RMAX;
    int src[64];
    for (int r = 0; r < cf.RMAX; ++r) src[r] = -1;
    for (int c = 0; c < C; ++c) {
      if (!t_found[c]) continue;
      if (slot[c] >= 0 && slot[c] < cf.RMAX) src[slot[c]] = c;
      if (c_rf[c] == -1) c_rf[c] = slot[c] + 1;
      c_rs[c] = imax[c];
    }
    const int8_t* labels = S.labels + gl * cf.MAXLEN;
    for (int r = 0; r < cf.RMAX; ++r) {
      const int c = src[r];
      if (c < 0) continue;
      int8_t* dst = S.res_labels + (gr + r) * cf.MAXLEN;
      const int8_t* from = labels + (size_t)(c >> 2) * cf.MAXLEN;
      for (int m = 0; m < cur_len_new - 1; ++m) dst[m] = from[m];
      if (cur_len_new - 1 < cf.MAXLEN) dst[cur_len_new - 1] = (int8_t)((c & 3) + 1);
      S.res_len[gr + r] = cur_len_new;
      S.res_err[gr + r] = gerr[c];
      S.res_i[gr + r] = imax[c];
    }
    const bool fp_hazard = hazA || (hazBC && need_l1);
    const int res_count_new = res_count + n_newres;

    // compact survivors into leaf slots, in candidate order; the new
    // leaves' labels, rings and chains go to scratch first
    const int nleaf = min(n_surv, L);
    int lsrc[LM];
    for (int c = 0, k = 0; c < C && k < nleaf; ++c)
      if (surv[c]) lsrc[k++] = c;
    int8_t* lab_tmp = reinterpret_cast<int8_t*>(scratch);
    float* ring_tmp = reinterpret_cast<float*>(scratch + (L * cf.MAXLEN + 3) / 4);
    int* chain_tmp = scratch + (L * cf.MAXLEN + 3) / 4 + L * cf.RING;
    const int ckmask = (1 << (2 * CK)) - 1;
    int new_tail8[LM];
    for (int l = 0; l < nleaf; ++l) {
      const int c = lsrc[l], p = c >> 2, ch = (c & 3) + 1;
      const int8_t* from = labels + (size_t)p * cf.MAXLEN;
      int8_t* to = lab_tmp + (size_t)l * cf.MAXLEN;
      for (int m = 0; m < cur_len_new - 1; ++m) to[m] = from[m];
      to[cur_len_new - 1] = (int8_t)ch;
      const float* rf = S.ring + (gl + p) * cf.RING;
      float* rt = ring_tmp + (size_t)l * cf.RING;
      for (int m = 0; m < cf.RING; ++m) rt[m] = rf[m];
      rt[slot_w] = gerr[c];
      // chain: slot j >= 1 = parent slot j-1 extended by ch; slot 0 from
      // the ck-mer cache of the new tail
      new_tail8[l] = ((S.tail8[gl + p] << 2) | (ch - 1)) & ckmask;
      int* ct = chain_tmp + (size_t)l * 4 * NC;
      int w4[4];
      wcache_get(ix, new_tail8[l], w4);
      for (int q = 0; q < 4; ++q) ct[q * NC] = w4[q];
      for (int j = 1; j < NC; ++j) {
        int a = chain_at(p, 0, j - 1), z = chain_at(p, 1, j - 1);
        int u = chain_at(p, 2, j - 1), w = chain_at(p, 3, j - 1);
        if (cf.SLAB && a > z) {
          a = 0;
          z = -1;
        } else {
          lf_f(ix, ch, a, z);
        }
        if (cf.SLAB && u > w) {
          u = 0;
          w = -1;
        } else {
          lf_r(ix, comp(ch), u, w);
        }
        ct[j] = a;
        ct[NC + j] = z;
        ct[2 * NC + j] = u;
        ct[3 * NC + j] = w;
      }
    }
    // per-leaf scalars of the new leaves (read from the parents first)
    int nl[LM][19];
    for (int l = 0; l < nleaf; ++l) {
      const int c = lsrc[l], p = c >> 2, ch = (c & 3) + 1;
      const size_t pp = gl + p;
      int* v = nl[l];
      v[0] = c_flo[c];
      v[1] = c_fhi[c];
      v[2] = c_rlo[c];
      v[3] = c_rhi[c];
      v[4] = c_freq[c];
      v[5] = S.total_kmer[pp] + c_freq[c];
      v[6] = c_last_seed[c];
      v[7] = c_last_ovl[c];
      v[8] = c_total_seeds[c];
      v[9] = c_covl[c];
      v[10] = c_num_err[c];
      v[11] = c_sio[c];
      v[12] = c_qovl[c];
      v[13] = c_red_a[c];
      v[14] = c_red_b[c];
      v[15] = c_rf[c];
      v[16] = c_rs[c];
      v[17] = (int)S.tail_letter[pp] == ch ? S.tail_count[pp] + 1 : 1;
      v[18] = ((S.tail9[pp] << 3) | ch) & ((1 << 27) - 1);
    }
    for (int l = 0; l < nleaf; ++l) {
      const int c = lsrc[l];
      const size_t q = gl + l;
      const int* v = nl[l];
      S.f_lo[q] = v[0];
      S.f_hi[q] = v[1];
      S.r_lo[q] = v[2];
      S.r_hi[q] = v[3];
      S.kmer_freq[q] = v[4];
      S.total_kmer[q] = v[5];
      S.last_seed_idx[q] = v[6];
      S.last_overlap_len[q] = v[7];
      S.total_seeds[q] = v[8];
      S.curr_overlap_len[q] = v[9];
      S.num_errors[q] = v[10];
      S.seed_idx_offset[q] = v[11];
      S.query_overlap_len[q] = v[12];
      S.red_a[q] = v[13];
      S.red_b[q] = v[14];
      S.res_first[q] = v[15];
      S.res_second[q] = v[16];
      S.tail_letter[q] = (int8_t)((c & 3) + 1);
      S.tail_count[q] = v[17];
      S.tail9[q] = v[18];
      S.tail8[q] = new_tail8[l];
      S.local_err[q] = local[c];
      S.gerr_last[q] = gerr[c];
      int8_t* lab = S.labels + q * cf.MAXLEN;
      const int8_t* lt = lab_tmp + (size_t)l * cf.MAXLEN;
      for (int m = 0; m < cur_len_new; ++m) lab[m] = lt[m];
      float* rg = S.ring + q * cf.RING;
      const float* rt = ring_tmp + (size_t)l * cf.RING;
      for (int m = 0; m < cf.RING; ++m) rg[m] = rt[m];
      int* ch = S.chain + q * 4 * NC;
      const int* ct = chain_tmp + (size_t)l * 4 * NC;
      for (int m = 0; m < 4 * NC; ++m) ch[m] = ct[m];
    }
    for (int l = 0; l < L; ++l) alive[l] = l < nleaf;

    // >maxLeaves: the reference's while-condition exit (-3, or 1 with
    // results); n_surv > L below it: re-run in the wide config (-200)
    if (n_surv > cf.MAXLEAVES) code = res_count_new > 0 ? 1 : -3;
    else if (n_surv > L) code = -200;
    S.code[g] = code;
    S.cur_len[g] = cur_len_new;
    S.cur_k[g] = cur_k_new;
    if (success) S.gerr_n[g] = n_app;
    S.res_count[g] = res_count_new;
    S.res_overflow[g] = S.res_overflow[g] || any_over || fp_hazard;
  }

  // _reduce_results: the first slot with the least error below 1.0
  __device__ void reduce(const Reduced& R, int out) const {
    const size_t gr = (size_t)g * cf.RMAX;
    const int n = min(S.res_count[g], cf.RMAX);
    int best = -1;
    float be = 0.0f;
    for (int r = 0; r < n; ++r) {
      const float e = S.res_err[gr + r];
      if (e < 1.0f && (best < 0 || e < be)) {
        best = r;
        be = e;
      }
    }
    const bool has = best >= 0;
    if (!has) best = 0;
    R.code[out] = S.code[g];
    R.overflow[out] = S.res_overflow[g];
    R.has[out] = has;
    const int8_t* from = S.res_labels + (gr + best) * cf.MAXLEN;
    int8_t* to = R.lab + (size_t)out * cf.MAXLEN;
    for (int m = 0; m < cf.MAXLEN; ++m) to[m] = from[m];
    R.len[out] = S.res_len[gr + best];
    R.i[out] = S.res_i[gr + best];
  }

  // _init_state of one used lane from task row t
  __device__ void seed(const Root& RT) const {
    const int L = cf.L, NC = cf.NC;
    const size_t gl = (size_t)g * L;
    const int ik = K.init_k[t];
    const int8_t* q = K.query + (size_t)t * cf.QMAX;
    for (int l = 0; l < L; ++l) {
      int8_t* lab = S.labels + (gl + l) * cf.MAXLEN;
      for (int m = 0; m < cf.MAXLEN; ++m)
        lab[m] = (l == 0 && m < ik && m < cf.QMAX) ? q[m] : (int8_t)kPad;
      const bool u = l == 0;
      const size_t x = gl + l;
      S.f_lo[x] = u ? RT.f_lo[t] : 0;
      S.f_hi[x] = u ? RT.f_hi[t] : -1;
      S.r_lo[x] = u ? RT.r_lo[t] : 0;
      S.r_hi[x] = u ? RT.r_hi[t] : -1;
      S.alive[x] = u;
      S.kmer_freq[x] = u ? RT.freq[t] : 0;
      S.total_kmer[x] = 0;
      S.last_seed_idx[x] = u ? ik - cf.SS : 0;
      S.last_overlap_len[x] = u ? ik : 0;
      S.total_seeds[x] = u ? ik - cf.SS + 1 : 0;
      S.curr_overlap_len[x] = u ? ik : 0;
      S.num_errors[x] = 0;
      S.seed_idx_offset[x] = 0;
      S.query_overlap_len[x] = u ? ik : 0;
      S.red_a[x] = 0;
      S.red_b[x] = 0;
      S.res_first[x] = -1;
      S.res_second[x] = -1;
      S.tail_letter[x] = u ? RT.tail_letter[t] : (int8_t)0;
      S.tail_count[x] = u ? RT.tail_count[t] : 0;
      S.tail9[x] = u ? RT.tail9[t] : 0;
      S.tail8[x] = u ? RT.tail8[t] : 0;
      int* ch = S.chain + x * 4 * NC;
      for (int qq = 0; qq < 4; ++qq)
        for (int j = 0; j < NC; ++j)
          ch[qq * NC + j] = u ? RT.chain0[((size_t)t * 4 + qq) * NC + j]
                              : ((qq & 1) ? -1 : 0);
      S.local_err[x] = 0.0f;
      S.gerr_last[x] = 0.0f;
      for (int m = 0; m < cf.RING; ++m) S.ring[x * cf.RING + m] = 0.0f;
    }
    S.active[g] = true;
    S.cur_len[g] = ik;
    S.cur_k[g] = ik;
    S.gerr_n[g] = 1;
    S.code[g] = 0;
    const size_t gr = (size_t)g * cf.RMAX;
    for (int r = 0; r < cf.RMAX; ++r) {
      int8_t* lab = S.res_labels + (gr + r) * cf.MAXLEN;
      for (int m = 0; m < cf.MAXLEN; ++m) lab[m] = (int8_t)kPad;
      S.res_len[gr + r] = 0;
      S.res_err[gr + r] = 0.0f;
      S.res_i[gr + r] = 0;
    }
    S.res_count[g] = 0;
    S.res_overflow[g] = false;
  }
};

// ---------------------------------------------------------------------------
// prep (_prep_core) of one task, split over `nthr` cooperating threads
// ---------------------------------------------------------------------------

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
};

__device__ void prep_task(const Index& ix, const PrepIn& P, const PrepOut& O, int t,
                          int tid, int nthr) {
  const int QMAX = P.QMAX, TMAX = P.TMAX, CK = P.CK, NC = P.KMAX - P.CK + 1;
  const int TW = TMAX + P.KMAX;
  const int ckmask = (1 << (2 * CK)) - 1;
  const int8_t* q = P.query + (size_t)t * QMAX;
  const int8_t* tr = P.trg + (size_t)t * TW;
  const int qlen = P.q_len[t], ik = P.init_k[t], mo = P.min_overlap[t];
  auto qc = [&](int p) { return p < QMAX ? (int)q[p] : kPad; };
  auto q14 = [&](int p) { return clampi((int)q[clampi(p, 0, QMAX - 1)], 1, 4); };

  // qcode9 / qcode5 rows
  for (int p = tid; p < QMAX; p += nthr) {
    int c9 = 0, c5 = 0;
    for (int j = 0; j < P.SS; ++j) c9 = (c9 << 3) | qc(p + j);
    for (int j = 0; j < 5; ++j) c5 = (c5 << 3) | qc(p + j);
    O.qcode9[(size_t)t * QMAX + p] = p < qlen - P.SS + 1 ? c9 : -1;
    O.qcode5[(size_t)t * QMAX + p] = p < qlen - 5 + 1 ? c5 : -1;
  }
  // terminal intervals: window m of trg, length min_overlap
  for (int m = tid; m < TMAX; m += nthr) {
    auto tch = [&](int j) { return clampi((int)tr[j + m], 1, 4); };
    int st[4];
    int from = 1;
    if (P.use_wcache) {
      int code = 0;
      for (int j = 0; j < CK; ++j) code = ((code << 2) | (tch(j) - 1)) & ckmask;
      wcache_get(ix, code, st);
      from = CK;
    } else {
      init_bi(ix, tch(0), st);
    }
    for (int j = from; j < P.kb_term; ++j)
      if (j < mo) extend_bi(ix, tch(j), st);
    const bool valid = m < P.n_term[t];
    int* tf = O.term_f + ((size_t)t * TMAX + m) * 2;
    int* trr = O.term_r + ((size_t)t * TMAX + m) * 2;
    tf[0] = valid ? st[0] : 1;
    tf[1] = valid ? st[1] : 0;
    trr[0] = valid ? st[2] : 1;
    trr[1] = valid ? st[3] : 0;
  }
  // chain ring of the root leaf: suffixes of length CK + i
  for (int i = tid; i < NC; i += nthr) {
    const int ks = CK + i, start = ik - ks;
    int st[4];
    int from = 1;
    if (P.use_wcache) {
      int code = 0;
      for (int j = 0; j < CK; ++j) code = ((code << 2) | (q14(start + j) - 1)) & ckmask;
      wcache_get(ix, code, st);
      from = CK;
    } else {
      init_bi(ix, q14(start), st);
    }
    for (int j = from; j < max(P.kb_root, CK); ++j)
      if (j < ks) extend_bi(ix, q14(start + j), st);
    const bool ok = ks <= ik;
    int* c0 = O.chain0 + (size_t)t * 4 * NC;
    c0[i] = ok ? st[0] : 0;
    c0[NC + i] = ok ? st[1] : -1;
    c0[2 * NC + i] = ok ? st[2] : 0;
    c0[3 * NC + i] = ok ? st[3] : -1;
  }
  if (tid != 0) return;
  // root leaf interval: query[:init_k] left to right
  int st[4];
  int from = 1;
  if (P.use_wcache) {
    int code = 0;
    for (int j = 0; j < CK; ++j) code = ((code << 2) | (q14(j) - 1)) & ckmask;
    wcache_get(ix, code, st);
    from = CK;
  } else {
    init_bi(ix, q14(0), st);
  }
  for (int j = from; j < P.kb_root; ++j)
    if (j < ik) extend_bi(ix, q14(j), st);
  O.f_lo[t] = st[0];
  O.f_hi[t] = st[1];
  O.r_lo[t] = st[2];
  O.r_hi[t] = st[3];
  O.freq[t] = isize(st[0], st[1]) + isize(st[2], st[3]);
  // tail metadata
  int t9 = 0, t8 = 0;
  for (int i = 0; i < P.SS; ++i) {
    const int pos = ik - P.SS + i;
    if (pos >= 0) t9 = (t9 << 3) | (int)q[clampi(pos, 0, QMAX - 1)];
  }
  for (int i = 0; i < CK; ++i) {
    const int pos = ik - CK + i;
    if (pos >= 0) t8 = ((t8 << 2) | ((int)q[clampi(pos, 0, QMAX - 1)] - 1)) & ckmask;
  }
  O.tail9[t] = t9;
  O.tail8[t] = t8;
  O.tail_letter[t] = q[clampi(ik - 1, 0, QMAX - 1)];
  const int c0 = q[clampi(ik - 1, 0, QMAX - 1)];
  int cnt = 0;
  for (int i = 0; i < P.KMAX; ++i) {
    const int b = ik - 1 - i;
    if (b < 0 || (int)q[clampi(b, 0, QMAX - 1)] != c0) break;
    ++cnt;
  }
  O.tail_count[t] = cnt;
}

}  // namespace walk
}  // namespace lrsc
