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

constexpr int kSmax = 128;  // seed slots per read (seedscan.py:32 SMAX)

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
// [R,L] output.  Design: one block per read; four inclusive scans of the
// garbage/repeat flags in shared memory (warp shuffles, carried across
// 1024-position chunks) land in a per-read scratch row in global memory
// (L2-resident), which the ±150 window then reads: no read-length limit.
// ---------------------------------------------------------------------------

constexpr int kAttrThreads = 1024;

__global__ void attributes_kernel(const int* __restrict__ freq_scan,
                                  const int* __restrict__ prefix,
                                  const int* __restrict__ lens, int L, int scan_k,
                                  float rep_thr, float ratio_c,
                                  int* __restrict__ scratch, int* __restrict__ out) {
  __shared__ int4 warp_tot[kAttrThreads / 32];
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int len = lens[r];
  const int* pre = prefix + (size_t)r * (L + 1) * 4;
  const int* fs = freq_scan + (size_t)r * L;
  int* cs = scratch + (size_t)r * 4 * L;  // [4, L]: add_g, rem_g, add_r, rem_r

  int4 carry = make_int4(0, 0, 0, 0);
  for (int base = 0; base < L; base += blockDim.x) {
    const int p = base + tid;
    int4 v = make_int4(0, 0, 0, 0);
    if (p < L) {
      const int size = min(scan_k, len - p);
      const int take = min(max(min(p + scan_k, len), 0), L);
      const int* a = pre + (size_t)take * 4;
      const int* b = pre + (size_t)p * 4;
      const bool lowcx = low_complexity(a[0] - b[0], a[1] - b[1], a[2] - b[2],
                                        a[3] - b[3], (float)size);
      const int eff = lowcx ? -1 : fs[p];
      const bool add_g = eff < 0, rem_g = eff <= 0;
      const bool hot = (float)eff >= rep_thr;
      v = make_int4(add_g, rem_g, !add_g && hot, !rem_g && hot);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, v.x, o);
      const int y = __shfl_up_sync(0xffffffffu, v.y, o);
      const int z = __shfl_up_sync(0xffffffffu, v.z, o);
      const int w = __shfl_up_sync(0xffffffffu, v.w, o);
      if (lane >= o) {
        v.x += x;
        v.y += y;
        v.z += z;
        v.w += w;
      }
    }
    if (lane == 31) warp_tot[wid] = v;
    __syncthreads();
    if (wid == 0) {
      int4 t = lane < nwarps ? warp_tot[lane] : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, t.x, o);
        const int y = __shfl_up_sync(0xffffffffu, t.y, o);
        const int z = __shfl_up_sync(0xffffffffu, t.z, o);
        const int w = __shfl_up_sync(0xffffffffu, t.w, o);
        if (lane >= o) {
          t.x += x;
          t.y += y;
          t.z += z;
          t.w += w;
        }
      }
      if (lane < nwarps) warp_tot[lane] = t;
    }
    __syncthreads();
    const int4 before = wid > 0 ? warp_tot[wid - 1] : make_int4(0, 0, 0, 0);
    if (p < L) {
      cs[p] = carry.x + before.x + v.x;
      cs[L + p] = carry.y + before.y + v.y;
      cs[2 * L + p] = carry.z + before.z + v.z;
      cs[3 * L + p] = carry.w + before.w + v.w;
    }
    const int4 tot = warp_tot[nwarps - 1];
    carry.x += tot.x;
    carry.y += tot.y;
    carry.z += tot.z;
    carry.w += tot.w;
    __syncthreads();  // warp_tot is rewritten by the next chunk
  }

  // csum_at (seedscan.py:83-85): idx < 0 -> 0, else cs[clip(idx, 0, L-1)]
  auto at = [&](int k, int idx) {
    return idx < 0 ? 0 : cs[(size_t)k * L + min(idx, L - 1)];
  };
  for (int p = tid; p < L; p += blockDim.x) {
    const int left = max(p - 150, 0);
    const int right = min(p + 150, len - 1);
    const int box_garbage = at(0, right) - at(1, left - 1);
    const int box_repeat = at(2, right) - at(3, left - 1);
    const int size = (right - left + 1) - box_garbage;
    const float q = (float)box_repeat / (float)size;
    out[(size_t)r * L + p] = q >= ratio_c ? 2 : 1;
  }
}

// ---------------------------------------------------------------------------
// _scan_automaton (seedscan.py:97): the dynamic-k seed state machine.
//
// Bound: latency.  Lanes never interact, so each thread runs the JAX body
// (seedscan.py:137-239) for its read in a while (!done) loop; each step
// is a short chain of dependent loads from the (L2-resident) tables.  At
// R = 64 reads the launch is 64 threads on two SMs.
// ---------------------------------------------------------------------------

__global__ void scan_automaton_kernel(
    const int* __restrict__ freq, const bool* __restrict__ valid,
    const int* __restrict__ attr, const int* __restrict__ prefix,
    const int* __restrict__ lens, const float* __restrict__ thr, int K, int R, int L,
    int start_kmer, int up_bound, int off0, int off1, int off2, float hh,
    float inv_hh, int* __restrict__ n_out, int* __restrict__ starts,
    int* __restrict__ sizes, int* __restrict__ freqs, bool* __restrict__ reps,
    int* __restrict__ statics) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int len = lens[r];
  const int* arow = attr + (size_t)r * L;
  const int* pre = prefix + (size_t)r * (L + 1) * 4;
  const size_t o = (size_t)r * kSmax;
  for (int j = 0; j < kSmax; ++j) {
    starts[o + j] = 0;
    sizes[o + j] = 0;
    freqs[o + j] = 0;
    reps[o + j] = false;
    statics[o + j] = 0;
  }
  auto col = [&](int pos) { return arow[min(max(pos, 0), L - 1)]; };
  auto fidx = [&](int k, int pos) {
    return ((size_t)min(max(k, 0), K - 1) * R + r) * L + min(max(pos, 0), L - 1);
  };
  auto thrget = [&](int mode, int size) {
    return thr[min(max(mode, 0), 2) * K + min(max(size, 0), K - 1)];
  };
  auto offset = [&](int mode) {
    const int m = min(max(mode, 0), 2);
    return m == 0 ? off0 : (m == 1 ? off1 : off2);
  };

  int init_pos = 0, stat = 0, dyn_mode = 0, seed_pos = 0, dyn_size = 0;
  bool is_seed = false, is_rep = false, inner = false;
  int max_fixed = 0, next_init = 0, curr = 0, n = 0;
  bool done = len < start_kmer;
  while (!done) {
    if (!inner) {  // outer init for a new window
      const int ip = init_pos;
      const int dmode = col(ip);
      const int stat0 = start_kmer + offset(dmode);
      stat = stat0;
      dyn_mode = dmode;
      seed_pos = ip;
      dyn_size = stat0;
      is_seed = false;
      is_rep = false;
      max_fixed = ip + stat0 <= len ? freq[fidx(stat0, ip)] : -1;
      next_init = ip;
      curr = ip;
    }
    // one inner-loop iteration
    const bool exit_now = !(curr < len) || curr + stat > len;
    const bool work = !exit_now;
    const int static_mode = col(curr);
    if (work && is_seed) dyn_size += 1;
    const bool dyn_fake = seed_pos + dyn_size > len;
    const size_t di = fidx(dyn_size, seed_pos);
    const int dyn_freq = dyn_fake ? -1 : freq[di];
    const bool dyn_valid = dyn_fake ? false : valid[di];
    const int sfreq = freq[fidx(stat, curr)];
    const float dyn_thr = thrget(dyn_mode, dyn_size);
    const float stat_thr = thrget(static_mode, stat);
    const float rep_thr = (5.0f - (float)((static_mode >> 1) << 2)) * stat_thr;

    const bool fail = ((float)sfreq < stat_thr) | ((float)dyn_freq < dyn_thr) |
                      !dyn_valid | (dyn_size > up_bound);
    const float fd = (float)sfreq / (float)max_fixed;
    const bool low = !fail & (fd < hh);
    const bool high = !fail & !low & (fd > inv_hh);
    const bool go = work & !fail & !low & !high;
    const bool exit_fail = work & fail, exit_low = work & low, exit_high = work & high;

    if (exit_fail && is_seed) dyn_size -= 1;
    if (exit_low) dyn_size -= 1;
    if (exit_low) next_init += 1;
    if (exit_high) next_init = curr - 1;
    if (go) next_init = seed_pos + dyn_size - 1;
    if (exit_high) is_seed = false;
    if (go) is_seed = true;
    is_rep = is_rep | (go & ((float)sfreq >= rep_thr));
    if (go) max_fixed = max(max_fixed, sfreq);
    if (go) curr += 1;
    const bool exiting = exit_now | exit_fail | exit_low | exit_high;

    // on exit: low-complexity check + emission (seedscan.py:207-227)
    const int* a = pre + (size_t)min(max(seed_pos + dyn_size, 0), L) * 4;
    const int* b = pre + (size_t)min(max(seed_pos, 0), L) * 4;
    const bool lowcx = low_complexity(a[0] - b[0], a[1] - b[1], a[2] - b[2],
                                      a[3] - b[3], (float)dyn_size);
    if (exiting && is_seed && !lowcx) {
      const size_t slot = o + min(n, kSmax - 1);  // slot 127 is overwritten once full
      starts[slot] = seed_pos;
      sizes[slot] = dyn_size;
      freqs[slot] = max_fixed;
      reps[slot] = is_rep;
      statics[slot] = stat;
      if (n < kSmax) n += 1;
    }
    if (exiting) init_pos = next_init + 1;
    done = exiting && init_pos >= len;
    inner = !exiting;
  }
  n_out[r] = n;
}

// ---------------------------------------------------------------------------
// _estimate_best (seedscan.py:246): best start / end k per seed slot.
//
// Bound: latency of a short dependent walk per slot (one freq entry per
// step, L2-resident).  Design: one thread per (read, slot), the two pole
// walks in turn.  The XOR compares are the reference's
// (SeedFeature.cpp:43-78) and stay verbatim: for bit = +1 they are not
// kf > freq_bound.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int bfreq(const int* __restrict__ freq, int K, int R, int L,
                                     int r, int k, int pos, bool* oor) {
  *oor = (k >= K) | (k < 1);
  const int kc = min(max(k, 1), K - 1);
  const int pc = min(max(pos, 0), L - 1);
  return freq[((size_t)kc * R + r) * L + pc];
}

__device__ __forceinline__ int best_walk(const int* __restrict__ freq, int K, int R,
                                         int L, int r, bool valid_seed, bool pole_start,
                                         int start, int size, int stat, int upper,
                                         int lower, bool* oor_out) {
  int k = stat;
  bool o;
  int kf = bfreq(freq, K, R, L, r, k, pole_start ? start : start + size - k, &o);
  const int bit = kf > upper ? 1 : (kf < lower ? -1 : 0);
  bool active = valid_seed && bit != 0;
  const int freq_bound = bit > 0 ? upper : lower;
  const int cors_bound = bit > 0 ? lower : upper;
  const int size_bound = bit > 0 ? size : stat;
  bool oor = o && active;
  while (active) {
    const bool go = ((bit ^ kf) > (bit ^ freq_bound)) && ((bit ^ k) < (bit ^ size_bound));
    if (!go) break;
    k += bit;
    kf = bfreq(freq, K, R, L, r, k, pole_start ? start : start + size - k, &o);
    oor = oor || o;
  }
  const bool back = valid_seed && bit != 0 && ((bit ^ kf) < (bit ^ cors_bound));
  if (back) k -= bit;
  *oor_out = oor;
  return k;
}

__global__ void estimate_best_kernel(const int* __restrict__ freq,
                                     const int* __restrict__ n,
                                     const int* __restrict__ starts,
                                     const int* __restrict__ sizes,
                                     const int* __restrict__ statics, int K, int R,
                                     int L, int pb_coverage, int* __restrict__ sk,
                                     int* __restrict__ ek, bool* __restrict__ oor) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * kSmax) return;
  const int r = t / kSmax, j = t - r * kSmax;
  const int upper = pb_coverage >> 1, lower = pb_coverage >> 2;
  const bool valid_seed = j < n[r];
  bool o1, o2;
  sk[t] = best_walk(freq, K, R, L, r, valid_seed, true, starts[t], sizes[t],
                    statics[t], upper, lower, &o1);
  ek[t] = best_walk(freq, K, R, L, r, valid_seed, false, starts[t], sizes[t],
                    statics[t], upper, lower, &o2);
  oor[t] = o1 || o2;
}

// ---------------------------------------------------------------------------
// _remove_hitchhiking (seedscan.py:303): keep mask over the seed slots.
//
// Bound: the SMAX x SMAX pair test per read, from shared memory.  Design:
// one block of SMAX threads per read; thread t tests slot t as the subject
// of every earlier repeat query and as the query of every later repeat
// subject (axes of the JAX [R, SMAX, SMAX] mask).
// ---------------------------------------------------------------------------

__global__ void remove_hitchhiking_kernel(const int* __restrict__ n,
                                          const int* __restrict__ starts,
                                          const int* __restrict__ sizes,
                                          const int* __restrict__ freqs,
                                          const bool* __restrict__ reps, int radius,
                                          float hh, float inv_hh,
                                          bool* __restrict__ keep) {
  __shared__ int s_start[kSmax], s_end[kSmax], s_freq[kSmax];
  __shared__ bool s_rep[kSmax], s_valid[kSmax];
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t o = (size_t)r * kSmax;
  s_start[t] = starts[o + t];
  s_end[t] = starts[o + t] + sizes[o + t] - 1;
  s_freq[t] = freqs[o + t];
  s_rep[t] = reps[o + t];
  s_valid[t] = t < n[r];
  __syncthreads();
  bool hitch = false;
  for (int q = 0; q < t; ++q) {  // t as subject: query q repeat and fd < hh
    const bool pair = s_valid[q] && s_valid[t] && (s_start[t] - s_end[q] <= radius);
    const float fd = (float)s_freq[t] / (float)s_freq[q];
    hitch |= pair && s_rep[q] && (fd < hh);
  }
  for (int s = t + 1; s < kSmax; ++s) {  // t as query: subject s repeat and fd > 1/hh
    const bool pair = s_valid[t] && s_valid[s] && (s_start[s] - s_end[t] <= radius);
    const float fd = (float)s_freq[s] / (float)s_freq[t];
    hitch |= pair && s_rep[s] && (fd > inv_hh);
  }
  keep[o + t] = s_valid[t] && !hitch;
}

}  // namespace

extern "C" int lrsc_attributes(const int* freq_scan, const int* prefix, const int* lens,
                               int R, int L, int scan_k, float rep_thr, float ratio_c,
                               int* scratch, int* out, void* stream) {
  if (R > 0 && L > 0) {
    attributes_kernel<<<R, kAttrThreads, 0, (cudaStream_t)stream>>>(
        freq_scan, prefix, lens, L, scan_k, rep_thr, ratio_c, scratch, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int lrsc_scan_automaton(const int* freq, const bool* valid, const int* attr,
                                   const int* prefix, const int* lens, const float* thr,
                                   int K, int R, int L, int start_kmer, int up_bound,
                                   int off0, int off1, int off2, float hh, float inv_hh,
                                   int* n, int* starts, int* sizes, int* freqs,
                                   bool* reps, int* statics, void* stream) {
  const int threads = 32;
  if (R > 0) {
    scan_automaton_kernel<<<(R + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
        freq, valid, attr, prefix, lens, thr, K, R, L, start_kmer, up_bound, off0, off1,
        off2, hh, inv_hh, n, starts, sizes, freqs, reps, statics);
  }
  return (int)cudaGetLastError();
}

extern "C" int lrsc_estimate_best(const int* freq, const int* n, const int* starts,
                                  const int* sizes, const int* statics, int K, int R,
                                  int L, int pb_coverage, int* sk, int* ek, bool* oor,
                                  void* stream) {
  const int threads = 128;
  if (R > 0) {
    estimate_best_kernel<<<(R * kSmax + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(freq, n, starts, sizes, statics, K,
                                                   R, L, pb_coverage, sk, ek, oor);
  }
  return (int)cudaGetLastError();
}

extern "C" int lrsc_remove_hitchhiking(const int* n, const int* starts, const int* sizes,
                                       const int* freqs, const bool* reps, int R,
                                       int radius, float hh, float inv_hh, bool* keep,
                                       void* stream) {
  if (R > 0) {
    remove_hitchhiking_kernel<<<R, kSmax, 0, (cudaStream_t)stream>>>(
        n, starts, sizes, freqs, reps, radius, hh, inv_hh, keep);
  }
  return (int)cudaGetLastError();
}
