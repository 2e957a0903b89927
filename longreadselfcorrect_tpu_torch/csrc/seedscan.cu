// The seed phase after the k-mer table: position attributes, the dynamic-k
// seed automaton, best-k estimation and hitchhike removal.  Four kernels
// replacing the JAX package's ops/seedscan.py, each a per-lane transcript
// of its JAX function so the results are equal, not merely close.
//
// Every float here feeds a < / >= compare that must give the JAX float32
// result bit for bit, so this file is built with -fmad=false
// -prec-div=true -ftz=false (IEEE division, no contraction, denormals
// kept); x / 0 yields the same inf / NaN as XLA and compares the same.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cswap(int& a, int& b) {
  const int lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// isLowComplexity on the 4 base counts of a window of `size` symbols
// (seedscan.py:68-71, :213-216): sort ascending, then the f32 ratios.
__device__ __forceinline__ bool low_complexity(int a, int b, int c, int d, float size) {
  cswap(a, b);
  cswap(c, d);
  cswap(a, c);
  cswap(b, d);
  cswap(b, c);
  return ((float)d / size >= 0.7f) | ((float)(c + d) / size >= 0.9f);
}

// ---------------------------------------------------------------------------
// _attributes (seedscan.py:53): mode 1/2 per position.
//
// Bound: bytes, one pass over freq_scan [R,L] and prefix [R,L+1,4] and the
// [R,L] output; the chain is the read's length, then the prefix rows it
// picks, once per kAttrWords words of 32 positions a warp takes (their
// loads all in flight at once).  Design: one block per read.  The four
// flag families the window counts (add_g, rem_g, repeat, rep_rem) are one
// bit per position: a warp ballots each into one word per 32 positions, a
// warp per family turns the words' popcounts into an exclusive prefix over
// the whole read, and every csum_at is that prefix plus the popcount of
// the word's bits up to the position.  The whole read and not only the
// window: box_garbage subtracts rem_g's count before the window's left
// edge from add_g's count up to its right edge, so it is the window's
// eff < 0 count minus the eff == 0 positions left of it.  The masks and
// prefixes (32 bytes per 32 positions) live in a scratch row of the read
// in device memory: no read-length limit.  In shared memory the kernel
// ran 0.0006 ms faster at L 1536 and 0.007 at 20,224 on an H100, but
// only up to a read length the card's shared memory sets.  One block a
// read leaves a 64-read chunk on 64 of an H100's 132 SMs; at the main
// path's widths the kernel takes little more than an empty launch, and a
// second block of a read would need the first's word prefix (a second
// launch, or a look-back across blocks).
// ---------------------------------------------------------------------------

constexpr int kAttrThreads = 1024;  // at least 4 warps: one per family's prefix
constexpr int kAttrWords = 2;       // mask words a warp loads before it ballots them

// bits 0..b of a word
__device__ __forceinline__ unsigned through(int b) { return kFullMask >> (31 - b); }

__global__ void __launch_bounds__(kAttrThreads) attributes_kernel(
    const int* __restrict__ freq_scan, const int* __restrict__ prefix,
    const int* __restrict__ lens, int L, int scan_k, float rep_thr, float ratio_c,
    unsigned* __restrict__ scratch, int* __restrict__ out) {
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = (L + 31) >> 5;
  // [4, W] words of flags (add_g, rem_g, repeat, rep_rem), then [4, W]
  // counts of each family's set bits in the words before
  unsigned* mask = scratch + (size_t)r * 8 * W;
  int* before = reinterpret_cast<int*>(mask + 4 * W);
  const int len = lens[r];
  const int4* pre = reinterpret_cast<const int4*>(prefix) + (size_t)r * (L + 1);
  const int* fs = freq_scan + (size_t)r * L;

  for (int w0 = wid * kAttrWords; w0 < W; w0 += nwarps * kAttrWords) {
    // the loads of kAttrWords words first, all in flight at once
    int4 a[kAttrWords], b[kAttrWords];
    int f[kAttrWords];
#pragma unroll
    for (int u = 0; u < kAttrWords; ++u) {
      const int p = ((w0 + u) << 5) + lane;
      if (p < L) {
        a[u] = pre[min(max(min(p + scan_k, len), 0), L)];
        b[u] = pre[p];
        f[u] = fs[p];
      }
    }
#pragma unroll
    for (int u = 0; u < kAttrWords; ++u) {
      const int p = ((w0 + u) << 5) + lane;
      bool add_g = false, rem_g = false, hot = false;
      if (p < L) {
        const int size = min(scan_k, len - p);
        const bool lowcx = low_complexity(a[u].x - b[u].x, a[u].y - b[u].y, a[u].z - b[u].z,
                                          a[u].w - b[u].w, (float)size);
        const int eff = lowcx ? -1 : f[u];
        add_g = eff < 0;
        rem_g = eff <= 0;
        hot = (float)eff >= rep_thr;
      }
      const unsigned m0 = __ballot_sync(kFullMask, add_g);
      const unsigned m1 = __ballot_sync(kFullMask, rem_g);
      const unsigned m2 = __ballot_sync(kFullMask, !add_g && hot);
      const unsigned m3 = __ballot_sync(kFullMask, !rem_g && hot);
      const int w = w0 + u;
      if (lane == 0 && w < W) {
        mask[w] = m0;
        mask[W + w] = m1;
        mask[2 * W + w] = m2;
        mask[3 * W + w] = m3;
      }
    }
  }
  __syncthreads();
  if (wid < 4) {  // warp f: family f's prefix, a run of words a lane
    const unsigned* m = mask + wid * W;
    int* bf = before + wid * W;
    const int per = (W + 31) >> 5;
    const int w0 = min(lane * per, W), w1 = min(w0 + per, W);
    int s = 0;
    for (int w = w0; w < w1; ++w) s += __popc(m[w]);
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - s;
    for (int w = w0; w < w1; ++w) {
      bf[w] = run;
      run += __popc(m[w]);
    }
  }
  __syncthreads();

  // csum_at (seedscan.py:83-85): idx < 0 -> 0, else the inclusive count of
  // family f at clip(idx, 0, L-1).  The words are loaded whatever idx is,
  // so no branch stands between a position's eight loads.
  auto at = [&](int f, int idx) {
    const int i = min(max(idx, 0), L - 1), w = f * W + (i >> 5);
    const int v = before[w] + __popc(mask[w] & through(i & 31));
    return idx < 0 ? 0 : v;
  };
  int* orow = out + (size_t)r * L;
  for (int p = tid; p < L; p += blockDim.x) {
    const int left = max(p - 150, 0);
    const int right = min(p + 150, len - 1);
    const int box_garbage = at(0, right) - at(1, left - 1);
    const int box_repeat = at(2, right) - at(3, left - 1);
    const int size = (right - left + 1) - box_garbage;
    const float q = (float)box_repeat / (float)size;
    orow[p] = q >= ratio_c ? 2 : 1;
  }
}

// ---------------------------------------------------------------------------
// _scan_automaton (seedscan.py:97): the dynamic-k seed state machine.
//
// Bound: latency.  A read's automaton is one serial chain: the windows
// run in turn and each inner iteration is a chain of 2-3 dependent loads
// (attr, then the freq/valid entries its mode and sizes pick) from the
// L2-resident tables.  Its byte bound (the tables it touches, ~1 us a
// chunk) is far below one such chain, so what the design can cut is the
// number of dependent rounds on the chain.  Design, one block per read:
// * Most windows exit at their first iteration (77% of all iterations on
//   a 9%-error read), and what that iteration does depends only on the
//   window's start ip.  Every thread of the block runs the first
//   iteration of the windows starting at its positions, with the step
//   function the automaton itself runs, and a warp ballot sets bit p of a
//   shared mask when that window exits at once, emits nothing and moves
//   init_pos to p + 1.
// * Warp 0 runs the automaton.  From init_pos it finds the next clear
//   bit with a ballot over the mask words and __ffs: every set bit it
//   passes stands for a window that only advanced init_pos by one.
// * A window runs as rounds of 32 speculative steps: lane j assumes the j
//   steps before it were "go" steps, whose state follows from the
//   window's state and a prefix max of the static freqs (loaded in one
//   round, freq[stat, curr + j]), and runs one step from there; the first
//   lane that exits ends the window (its state is the window's), else
//   lane 31's state starts the next round.  So a window costs one round
//   per 32 inner iterations instead of one per iteration.
// * prefix is read only where a seed is emitted (the low-complexity
//   check); the threshold table sits in shared memory.
// * A read has smax seed slots, a launch parameter: at 128 (the JAX
//   design's count) the last slot is overwritten once all are full, and
//   the corrector sizes smax from the chunk's width so that no read fills
//   them (ops/seedscan.py seed_slots).
// * No read-length limit: the mask covers kSeg positions at a time, and
//   since init_pos never moves back, the block builds the next segment's
//   mask when the automaton leaves the current one.
// The step function is the JAX body (seedscan.py:137-239) verbatim,
// shared by the mask pass and the automaton, so its f32 compares (the
// -1 of a fake k-mer, 0/0, the clamped gathers) are one piece of code.
// ---------------------------------------------------------------------------

constexpr int kAutoThreads = 256;
constexpr int kSeg = 8192;  // positions per mask segment

struct AutoCtx {
  const int* __restrict__ freq;
  const bool* __restrict__ valid;
  const int* __restrict__ arow;  // attr of this read
  const float* thr;              // [3, K], in shared memory
  int K, R, L, r, len, start_kmer, up_bound, off0, off1, off2;
  float hh, inv_hh;

  __device__ int col(int pos) const { return __ldg(arow + min(max(pos, 0), L - 1)); }
  __device__ size_t fidx(int k, int pos) const {
    return ((size_t)min(max(k, 0), K - 1) * R + r) * L + min(max(pos, 0), L - 1);
  }
  __device__ float thrget(int mode, int size) const {
    return thr[min(max(mode, 0), 2) * K + min(max(size, 0), K - 1)];
  }
  __device__ int offset(int mode) const {
    const int m = min(max(mode, 0), 2);
    return m == 0 ? off0 : (m == 1 ? off1 : off2);
  }
};

// the state of one window (seedscan.py:120-135)
struct Win {
  int stat, dyn_mode, seed_pos, dyn_size, max_fixed, next_init, curr;
  bool is_seed, is_rep;
};

// the outer init of a window starting at ip
__device__ __forceinline__ Win window_init(const AutoCtx& c, int ip) {
  Win w;
  const int dmode = c.col(ip);
  const int stat0 = c.start_kmer + c.offset(dmode);
  w.stat = stat0;
  w.dyn_mode = dmode;
  w.seed_pos = ip;
  w.dyn_size = stat0;
  w.is_seed = false;
  w.is_rep = false;
  w.max_fixed = ip + stat0 <= c.len ? __ldg(c.freq + c.fidx(stat0, ip)) : -1;
  w.next_init = ip;
  w.curr = ip;
  return w;
}

// the static k-mer's freq at curr, the load an iteration makes first
__device__ __forceinline__ int static_freq(const AutoCtx& c, const Win& w) {
  return __ldg(c.freq + c.fidx(w.stat, w.curr));
}

// one inner-loop iteration; true when the window exits
__device__ __forceinline__ bool auto_step(const AutoCtx& c, Win& w) {
  const bool exit_now = !(w.curr < c.len) || w.curr + w.stat > c.len;
  const bool work = !exit_now;
  const int static_mode = c.col(w.curr);
  if (work && w.is_seed) w.dyn_size += 1;
  const bool dyn_fake = w.seed_pos + w.dyn_size > c.len;
  const size_t di = c.fidx(w.dyn_size, w.seed_pos);
  const int dyn_freq = dyn_fake ? -1 : __ldg(c.freq + di);
  const bool dyn_valid = dyn_fake ? false : c.valid[di];
  const int sfreq = static_freq(c, w);
  const float dyn_thr = c.thrget(w.dyn_mode, w.dyn_size);
  const float stat_thr = c.thrget(static_mode, w.stat);
  const float rep_thr = (5.0f - (float)((static_mode >> 1) << 2)) * stat_thr;

  const bool fail = ((float)sfreq < stat_thr) | ((float)dyn_freq < dyn_thr) |
                    !dyn_valid | (w.dyn_size > c.up_bound);
  const float fd = (float)sfreq / (float)w.max_fixed;
  const bool low = !fail & (fd < c.hh);
  const bool high = !fail & !low & (fd > c.inv_hh);
  const bool go = work & !fail & !low & !high;
  const bool exit_fail = work & fail, exit_low = work & low, exit_high = work & high;

  if (exit_fail && w.is_seed) w.dyn_size -= 1;
  if (exit_low) w.dyn_size -= 1;
  if (exit_low) w.next_init += 1;
  if (exit_high) w.next_init = w.curr - 1;
  if (go) w.next_init = w.seed_pos + w.dyn_size - 1;
  if (exit_high) w.is_seed = false;
  if (go) w.is_seed = true;
  w.is_rep = w.is_rep | (go & ((float)sfreq >= rep_thr));
  if (go) w.max_fixed = max(w.max_fixed, sfreq);
  if (go) w.curr += 1;
  return exit_now | exit_fail | exit_low | exit_high;
}

__device__ __forceinline__ Win shfl_win(const Win& s, int src) {
  Win w;
  w.stat = __shfl_sync(kFullMask, s.stat, src);
  w.dyn_mode = __shfl_sync(kFullMask, s.dyn_mode, src);
  w.seed_pos = __shfl_sync(kFullMask, s.seed_pos, src);
  w.dyn_size = __shfl_sync(kFullMask, s.dyn_size, src);
  w.max_fixed = __shfl_sync(kFullMask, s.max_fixed, src);
  w.next_init = __shfl_sync(kFullMask, s.next_init, src);
  w.curr = __shfl_sync(kFullMask, s.curr, src);
  w.is_seed = __shfl_sync(kFullMask, (int)s.is_seed, src) != 0;
  w.is_rep = false;
  return w;
}

// Runs the window that starts at ip on the whole warp (every lane ends
// with the same state); `rounds` counts its dependent rounds.
__device__ Win run_window(const AutoCtx& c, int ip, int lane, int& rounds) {
  Win w = window_init(c, ip);
  rounds += 1;
  for (;;) {
    Win s = w;
    s.curr = w.curr + lane;
    if (lane > 0) {  // steps 0 .. lane-1 were go steps
      s.dyn_size = w.dyn_size + (w.is_seed ? 1 : 0) + (lane - 1);
      s.is_seed = true;
      s.next_init = w.seed_pos + s.dyn_size - 1;
    }
    // max_fixed after those steps: the exclusive prefix max of the
    // static freqs of the lanes below
    int run = static_freq(c, s);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, run, o);
      if (lane >= o) run = max(run, v);
    }
    const int below = __shfl_up_sync(kFullMask, run, 1);
    if (lane > 0) s.max_fixed = max(w.max_fixed, below);
    s.is_rep = false;  // the flag this step alone raises
    const bool exits = auto_step(c, s);
    const unsigned ex = __ballot_sync(kFullMask, exits);
    const unsigned rep = __ballot_sync(kFullMask, s.is_rep);
    const int e = ex ? __ffs(ex) - 1 : 31;
    const bool was_rep = w.is_rep;
    w = shfl_win(s, e);
    w.is_rep = was_rep | ((rep & (kFullMask >> (31 - e))) != 0);
    rounds += 1;
    if (ex) return w;
  }
}

// The first clear bit of the mask at or after pos in [pos, seg_end), or
// seg_end.  mask bit i stands for position seg + i.
__device__ __forceinline__ int next_window(const unsigned* mask, int seg, int seg_end,
                                           int pos, int lane) {
  while (pos < seg_end) {
    const int w0 = (pos - seg) >> 5;
    const int wi = w0 + lane;
    unsigned open = 0;
    if (seg + (wi << 5) < seg_end) {
      open = ~mask[wi];
      if (lane == 0) open &= kFullMask << ((pos - seg) & 31);
    }
    const unsigned any = __ballot_sync(kFullMask, open != 0);
    if (any) {
      const int l = __ffs(any) - 1;
      const unsigned bits = __shfl_sync(kFullMask, open, l);
      return seg + ((w0 + l) << 5) + __ffs(bits) - 1;
    }
    pos = seg + ((w0 + 32) << 5);
  }
  return seg_end;
}

__global__ void __launch_bounds__(kAutoThreads) scan_automaton_kernel(
    const int* __restrict__ freq, const bool* __restrict__ valid,
    const int* __restrict__ attr, const int* __restrict__ prefix,
    const int* __restrict__ lens, const float* __restrict__ thr, int K, int R, int L,
    int start_kmer, int up_bound, int off0, int off1, int off2, float hh,
    float inv_hh, int smax, int* __restrict__ n_out, int* __restrict__ starts,
    int* __restrict__ sizes, int* __restrict__ freqs, bool* __restrict__ reps,
    int* __restrict__ statics, int* __restrict__ rounds_out) {
  extern __shared__ int4 auto_smem[];
  unsigned* mask = reinterpret_cast<unsigned*>(auto_smem);  // [kSeg / 32]
  float* s_thr = reinterpret_cast<float*>(mask + kSeg / 32);  // [3, K]
  int* s_next = reinterpret_cast<int*>(s_thr + 3 * K);        // init_pos, done
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int len = lens[r];
  const size_t o = (size_t)r * smax;
  for (int j = tid; j < smax; j += blockDim.x) {
    starts[o + j] = 0;
    sizes[o + j] = 0;
    freqs[o + j] = 0;
    reps[o + j] = false;
    statics[o + j] = 0;
  }
  for (int i = tid; i < 3 * K; i += blockDim.x) s_thr[i] = thr[i];
  const AutoCtx c{freq, valid, attr + (size_t)r * L, s_thr, K, R, L, r, len,
                  start_kmer, up_bound, off0, off1, off2, hh, inv_hh};
  const int* pre = prefix + (size_t)r * (L + 1) * 4;

  // warp 0's automaton state, kept across segments
  int init_pos = 0, n = 0, rounds = 0;
  bool done = len < start_kmer;
  int seg = 0;
  while (!done) {
    const int seg_end = min(seg + kSeg, len);
    __syncthreads();  // the automaton is done with the last segment's mask
    for (int b = seg + (tid & ~31); b < seg_end; b += blockDim.x) {
      const int p = b + lane;
      bool skip = true;  // no window starts past the read
      if (p < len) {
        Win w = window_init(c, p);
        skip = auto_step(c, w) && !w.is_seed && w.next_init == p;
      }
      const unsigned bits = __ballot_sync(kFullMask, skip);
      if (lane == 0) mask[(b - seg) >> 5] = bits;
    }
    __syncthreads();
    if (tid < 32) {
      while (!done && init_pos < seg_end) {
        const int ip = next_window(mask, seg, seg_end, init_pos, lane);
        if (ip >= seg_end) {  // every window up to seg_end exits at once
          init_pos = seg_end;
        } else {
          const Win w = run_window(c, ip, lane, rounds);
          // on exit: low-complexity check + emission (seedscan.py:207-227)
          if (w.is_seed) {
            const int* a = pre + (size_t)min(max(w.seed_pos + w.dyn_size, 0), L) * 4;
            const int* b = pre + (size_t)min(max(w.seed_pos, 0), L) * 4;
            const bool lowcx = low_complexity(a[0] - b[0], a[1] - b[1], a[2] - b[2],
                                              a[3] - b[3], (float)w.dyn_size);
            if (!lowcx) {
              if (lane == 0) {
                // the last slot is overwritten once all are full
                const size_t slot = o + min(n, smax - 1);
                starts[slot] = w.seed_pos;
                sizes[slot] = w.dyn_size;
                freqs[slot] = w.max_fixed;
                reps[slot] = w.is_rep;
                statics[slot] = w.stat;
              }
              if (n < smax) n += 1;
            }
          }
          init_pos = w.next_init + 1;
        }
        done = init_pos >= len;
      }
      if (tid == 0) {
        s_next[0] = init_pos;
        s_next[1] = done;
      }
    }
    __syncthreads();
    done = s_next[1] != 0;
    seg = s_next[0] / kSeg * kSeg;
  }
  if (tid == 0) {
    n_out[r] = n;
    if (rounds_out != nullptr) rounds_out[r] = rounds;
  }
}

// ---------------------------------------------------------------------------
// _estimate_best (seedscan.py:246): best start / end k per seed slot.
//
// Bound: latency.  Each pole (a seed's start or its end) walks k from its
// static size one level at a time while the freq stays past its bound,
// each step a dependent 4-byte load from the [K, R, L] table, R*L*4 bytes
// a level apart (5 MB on a 64 x 20,224 chunk, whose table outgrows L2);
// the bytes (~0.1 us a chunk on an H100) are nothing beside that chain.
// Design: a warp per pole.  A block takes kBestSlots seed slots of a read, so a
// warp has at most four poles (2j: seed j's start, 2j + 1: its end) to walk in
// turn, however many seeds the read has; lane t of a warp loads the records of
// its t-th pole up front.  A pole's walk runs as rounds of 32 speculative k
// steps: lane i takes level base + i * dir and loads its freq entry, and a
// ballot of the lanes whose step would not go finds where the walk stops; only
// when all 32 go does another round run. Whether a step goes depends on its
// level and that level's freq alone (seedscan.py:284-285), so a round is one
// load round.  The first round guesses dir = +1, since only lane 0's level (the
// static size) is known before the walk's direction: a walk down stops at once
// (its size bound is the static size), and a walk whose direction was guessed
// wrong would go on from lane 0 in its own.  oor ORs the out-of-table flags of
// the levels the walk visited, up to the stop and never past it.  The XOR
// compares are the reference's (SeedFeature.cpp:43-78) and stay verbatim: for
// bit = +1 they are not kf > freq_bound.
// ---------------------------------------------------------------------------

constexpr int kBestThreads = 1024;
constexpr int kBestSlots = 64;  // seed slots a block takes: 2 * 64 poles over 32 warps
static_assert(2 * kBestSlots <= 32 * (kBestThreads / 32), "a warp walks at most 32 poles");

// One pole's walk on the whole warp (every lane returns the same k).
// frow: the read's row of level 0; level: the table's stride between levels.
__device__ __forceinline__ int best_pole(const int* __restrict__ frow, size_t level, int K,
                                         int L, bool end, int start, int size, int stat,
                                         int upper, int lower, int lane, bool* oor_out) {
  int base = stat, dir = 1, bit = 0, freq_bound = 0, cors_bound = 0, size_bound = 0;
  bool oor = false;
  for (bool first = true;; first = false) {
    const int k = base + lane * dir;
    const int pos = end ? start + size - k : start;
    const int kf = __ldg(frow + (size_t)min(max(k, 1), K - 1) * level + min(max(pos, 0), L - 1));
    const bool o = (k >= K) | (k < 1);
    if (first) {
      const int kf0 = __shfl_sync(kFullMask, kf, 0);
      bit = kf0 > upper ? 1 : (kf0 < lower ? -1 : 0);
      if (bit == 0) {  // no walk
        *oor_out = false;
        return stat;
      }
      freq_bound = bit > 0 ? upper : lower;
      cors_bound = bit > 0 ? lower : upper;
      size_bound = bit > 0 ? size : stat;
    }
    // the lanes whose level the walk can reach: all once dir is the walk's
    const int reach = dir == bit ? 32 : 1;
    const bool go = ((bit ^ kf) > (bit ^ freq_bound)) && ((bit ^ k) < (bit ^ size_bound));
    const unsigned stop = __ballot_sync(kFullMask, lane < reach && !go);
    const unsigned visited = stop ? through(__ffs(stop) - 1) : kFullMask >> (32 - reach);
    oor |= (__ballot_sync(kFullMask, o) & visited) != 0;
    if (stop) {
      const int s = __ffs(stop) - 1;
      const int ks = __shfl_sync(kFullMask, k, s), kfs = __shfl_sync(kFullMask, kf, s);
      *oor_out = oor;
      return (bit ^ kfs) < (bit ^ cors_bound) ? ks - bit : ks;
    }
    base += reach * bit;
    dir = bit;
  }
}

__global__ void __launch_bounds__(kBestThreads) estimate_best_kernel(
    const int* __restrict__ freq, const int* __restrict__ n, const int* __restrict__ starts,
    const int* __restrict__ sizes, const int* __restrict__ statics, int K, int R, int L,
    int smax, int pb_coverage, int* __restrict__ sk, int* __restrict__ ek,
    bool* __restrict__ oor) {
  const int blocks = (smax + kBestSlots - 1) / kBestSlots;  // a read's blocks
  const int r = blockIdx.x / blocks, j0 = blockIdx.x % blocks * kBestSlots;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nr = min(max(n[r], 0), smax), poles = 2 * max(min(nr - j0, kBestSlots), 0);
  const int upper = pb_coverage >> 1, lower = pb_coverage >> 2;
  const size_t o = (size_t)r * smax + j0;  // this block's first slot
  // every slot's oor starts false; an empty slot keeps its static size
  for (int j = tid; j < min(kBestSlots, smax - j0); j += blockDim.x) {
    oor[o + j] = false;
    if (j0 + j >= nr) {
      const int s = statics[o + j];
      sk[o + j] = s;
      ek[o + j] = s;
    }
  }
  __syncthreads();  // a walk that leaves the table sets its slot's oor after this
  const int* frow = freq + (size_t)r * L;
  const size_t level = (size_t)R * L;
  // lane t: the records of this warp's t-th pole, wid + t * nwarps
  const int qt = wid + lane * nwarps;
  int ps = 0, pz = 0, pk = 0;
  if (qt < poles) {
    const size_t j = o + (qt >> 1);
    ps = starts[j];
    pz = sizes[j];
    pk = statics[j];
  }
  for (int t = 0; wid + t * nwarps < poles; ++t) {
    const int q = wid + t * nwarps;
    bool hit;
    const int k = best_pole(frow, level, K, L, q & 1, __shfl_sync(kFullMask, ps, t),
                            __shfl_sync(kFullMask, pz, t), __shfl_sync(kFullMask, pk, t),
                            upper, lower, lane, &hit);
    if (lane == 0) {
      (q & 1 ? ek : sk)[o + (q >> 1)] = k;
      if (hit) oor[o + (q >> 1)] = true;
    }
  }
}

// ---------------------------------------------------------------------------
// _remove_hitchhiking (seedscan.py:303): keep mask over the seed slots.
//
// Bound: bytes, each valid slot's records read once and its keep flag
// written once; only the pairs within the radius can mark a slot.  Design:
// a warp per 32 slots of a read (a grid of R x ceil(smax / 32) warps, a
// warp past its read's n only clears its flags), each lane deciding its
// own slot from the records in device memory (through L1): no shared
// array of the read's slots, so no read length caps the kernel, and no
// atomics.  The automaton emits a read's seeds in order and without
// overlap, so their starts and ends ascend; then the subjects in reach of
// query q are the run q+1.. up to the first start past end[q] + radius,
// and the queries in reach of subject t the run down to the first end
// before start[t] - radius: a few slots each at the main path's radius,
// where the JAX mask tests all n^2 pairs.  Each warp checks that order
// over its read's n slots (32 slots a load round, one vote of the warp:
// starts and ends non-decreasing and within +-2^30, so that no difference
// wraps); the walks stop at the first slot out of reach only in such a
// read, and in any other every lane tests all its pairs, as the mask does.
// The chain is the launch, then n beside the lane's own record, the order
// check's rounds, and the longer of the two walks, which step side by side
// with each step's records in one round of loads (L1 hits mostly).
// ---------------------------------------------------------------------------

constexpr int kHitchWarps = 4;        // warps a block, each on 32 slots of one read
constexpr int kHitchReach = 1 << 30;  // records within +-kHitchReach: no wrapping gap

// a - b with int32 wrap-around, as the JAX / torch int32 arithmetic
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// start + size - 1 of slot j, with int32 wrap-around
__device__ __forceinline__ int seed_end(const int* __restrict__ starts,
                                        const int* __restrict__ sizes, size_t j) {
  return (int)((unsigned)__ldg(starts + j) + (unsigned)__ldg(sizes + j) - 1u);
}

__device__ __forceinline__ bool out_of_reach(int x) {
  return x < -kHitchReach || x >= kHitchReach;
}

// Whether slots 0..nr-1 (from o; nr >= 1) have non-decreasing starts and
// ends, all within +-kHitchReach; warp-uniform.  Each lane compares a slot
// with the one before it (slot 0 with itself; lanes past nr take slot
// nr - 1), so every load is unconditional and a round's loads, four rounds
// of them, are in flight together.
__device__ __forceinline__ bool hitch_in_order(const int* __restrict__ starts,
                                               const int* __restrict__ sizes, size_t o,
                                               int nr, int lane) {
  bool bad = false;
#pragma unroll 4
  for (int b = 0; b < nr; b += 32) {
    const int i = min(b + lane, nr - 1), h = max(i - 1, 0);
    const int st = __ldg(starts + o + i), en = seed_end(starts, sizes, o + i);
    const int ps = __ldg(starts + o + h), pe = seed_end(starts, sizes, o + h);
    bad |= out_of_reach(st) | out_of_reach(en) | (st < ps) | (en < pe);
  }
  return !__any_sync(kFullMask, bad);
}

__global__ void __launch_bounds__(kHitchWarps * 32) remove_hitchhiking_kernel(
    const int* __restrict__ n, const int* __restrict__ starts,
    const int* __restrict__ sizes, const int* __restrict__ freqs,
    const bool* __restrict__ reps, int R, int smax, int radius, float hh, float inv_hh,
    bool* __restrict__ keep) {
  const int tiles = (smax + 31) / 32;
  const size_t w = (size_t)blockIdx.x * kHitchWarps + threadIdx.x / 32;
  if (w >= (size_t)R * tiles) return;  // a whole warp
  const int r = (int)(w / tiles), lane = threadIdx.x & 31;
  const int t0 = (int)(w - (size_t)r * tiles) * 32, t = t0 + lane;
  const size_t o = (size_t)r * smax;
  // the lane's own record, loaded beside n
  const size_t j = o + min(t, smax - 1);
  const int st = __ldg(starts + j), en = seed_end(starts, sizes, j);
  const float ft = (float)__ldg(freqs + j);
  const int nr = min(__ldg(n + r), smax);
  if (t0 >= nr) {  // every slot of the warp is empty
    if (t < smax) keep[o + t] = false;
    return;
  }
  const bool ordered = hitch_in_order(starts, sizes, o, nr, lane);
  // the two walks side by side, step d testing query t - d (t the
  // subject: q a repeat and f[t] / f[q] < hh) and subject t + d (t the
  // query: s a repeat and f[s] / f[t] > 1 / hh), both steps' records in
  // one round of loads (indices clamped into the read); in order, a walk
  // ends at its first pair out of reach
  bool hitch = false, down = t < nr, up = t < nr;
  for (int d = 1; (down || up) && !hitch; ++d) {
    const int q = max(t - d, 0), s = min(t + d, nr - 1);
    down &= t - d >= 0;
    up &= t + d < nr;
    const int eq = seed_end(starts, sizes, o + q), ss = __ldg(starts + o + s);
    const bool rq = reps[o + q], rs = reps[o + s];
    const float fq = (float)__ldg(freqs + o + q), fs = (float)__ldg(freqs + o + s);
    const bool nq = down && wrap_sub(st, eq) <= radius;
    const bool ns = up && wrap_sub(ss, en) <= radius;
    hitch = (nq & rq & (ft / fq < hh)) | (ns & rs & (fs / ft > inv_hh));
    if (ordered) {
      down = nq;
      up = ns;
    }
  }
  if (t < smax) keep[o + t] = t < nr && !hitch;
}

}  // namespace

// scratch: R x 8 x ceil(L/32) words, a read's flag masks and their prefixes
extern "C" int lrsc_attributes(const int* freq_scan, const int* prefix, const int* lens,
                               int R, int L, int scan_k, float rep_thr, float ratio_c,
                               int* scratch, int* out, void* stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (R < 1 || L < 1) return (int)cudaGetLastError();
  attributes_kernel<<<R, kAttrThreads, 0, (cudaStream_t)stream>>>(
      freq_scan, prefix, lens, L, scan_k, rep_thr, ratio_c,
      reinterpret_cast<unsigned*>(scratch), out);
  return (int)cudaGetLastError();
}

// rounds (may be null): per read, the automaton's dependent rounds (one
// per window started and one per round of 32 speculative steps)
extern "C" int lrsc_scan_automaton(const int* freq, const bool* valid, const int* attr,
                                   const int* prefix, const int* lens, const float* thr,
                                   int K, int R, int L, int start_kmer, int up_bound,
                                   int off0, int off1, int off2, float hh, float inv_hh,
                                   int smax, int* n, int* starts, int* sizes, int* freqs,
                                   bool* reps, int* statics, int* rounds, void* stream) {
  const size_t shmem = sizeof(unsigned) * (kSeg / 32) + sizeof(float) * 3 * K + 2 * sizeof(int);
  if (K < 1 || L < 1 || smax < 1 || shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    scan_automaton_kernel<<<R, kAutoThreads, shmem, (cudaStream_t)stream>>>(
        freq, valid, attr, prefix, lens, thr, K, R, L, start_kmer, up_bound, off0, off1,
        off2, hh, inv_hh, smax, n, starts, sizes, freqs, reps, statics, rounds);
  }
  return (int)cudaGetLastError();
}

extern "C" int lrsc_estimate_best(const int* freq, const int* n, const int* starts,
                                  const int* sizes, const int* statics, int K, int R,
                                  int L, int smax, int pb_coverage, int* sk, int* ek,
                                  bool* oor, void* stream) {
  if (smax < 1) return (int)cudaErrorInvalidValue;
  const size_t blocks = (size_t)R * ((smax + kBestSlots - 1) / kBestSlots);
  if (blocks > 0) {
    estimate_best_kernel<<<(unsigned)blocks, kBestThreads, 0, (cudaStream_t)stream>>>(
        freq, n, starts, sizes, statics, K, R, L, smax, pb_coverage, sk, ek, oor);
  }
  return (int)cudaGetLastError();
}

extern "C" int lrsc_remove_hitchhiking(const int* n, const int* starts, const int* sizes,
                                       const int* freqs, const bool* reps, int R, int smax,
                                       int radius, float hh, float inv_hh, bool* keep,
                                       void* stream) {
  if (smax < 1) return (int)cudaErrorInvalidValue;
  const size_t warps = (size_t)R * ((smax + 31) / 32);
  if (warps > 0) {
    remove_hitchhiking_kernel<<<(unsigned)((warps + kHitchWarps - 1) / kHitchWarps),
                                kHitchWarps * 32, 0, (cudaStream_t)stream>>>(
        n, starts, sizes, freqs, reps, R, smax, radius, hh, inv_hh, keep);
  }
  return (int)cudaGetLastError();
}
