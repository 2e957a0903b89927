// The FM-extension walk engine: four kernels replacing the JAX package's
// ops/walk.py device functions (the per-lane logic is in walk.cuh).
//
// * wcache_level_up (walk.py:124 _wcache_level_up): one thread per
//   parent interval of level k (n = 4^k), its four children written as
//   one 16-byte vector per output.  Bound: the index rows read (the
//   level reads nearly every row of both BWTs at k = 11) and the children
//   written.  A child's four ends are rank queries at the parent's four
//   positions with another symbol, so the thread reads each position's
//   row once and counts all four symbols from it (rank.cuh
//   occ_acgt_pair: half a row an end, one half for both ends where they
//   share it): at most 4 row loads a parent, where one thread per child
//   made 16 queries.  The parents are visited in the order of their
//   intervals: the forward interval of word w is the SA range of
//   reverse(w), which sorts by the last base first, then the one before;
//   thread g takes the parent whose last kLevelRun bases are those of g
//   and whose other k - kLevelRun bases, read from last to first, are the
//   base-4 digits of the rest of g.  So within each of the 4^kLevelRun
//   streams f_lo rises with g and r_lo (the BWT interval of the reverse
//   complement, sorted by the complemented bases) falls, a warp reads a
//   few neighbouring rows per stream, and a level reads each row from
//   device memory about once; the 16 parents of a run are consecutive
//   codes, so their inputs are read and their children written as whole
//   sectors.
// * walk_prep (walk.py:371 _prep_core via :586/:598/:1986): one warp per
//   task (walk.cuh prep_task): the task's rows staged in shared memory,
//   the code rows written by the whole warp, one lane per LF ladder whose
//   output is not a constant.  Bound: the code rows written and the
//   ladders' rank rows; a launch lasts about its longest ladder's chain of
//   dependent LF steps (init_k - CK at most).
// * walk_steps (walk.py:997 superstep, :1639 multistep, :1647
//   run_to_completion, :1600 _reduce_results): one warp per gap lane loads
//   the lane's WalkState row into shared memory, runs up to n supersteps
//   (a lane that has finished no longer changes, so multistep and
//   run_to_completion are the same loop), writes the row back and reduces.
// * walk_queue (walk.py:1802 queue_run): a persistent grid, as many warps
//   as fit the card; lane 0 of a warp takes the next task of the bank from
//   a head counter (atomicAdd), the warp seeds it in shared memory
//   (_init_state), walks it to completion or max_steps (-900) and writes
//   its reduction.  No lane state lives in device memory.  A task's result
//   does not depend on the warp that walks it.
// Bound of the walk kernels: the rank queries of every superstep (random
// 128-byte rows in a 2 x ~140 MB index at the bench scale).  A superstep
// is a chain of rounds of independent rank queries, each round spread over
// the warp (walk.cuh), so a step costs a few memory latencies; the lane
// state stays in shared memory (walk.cuh's layout) and touches device
// memory only at load, write-back and results.
//
// Built with -fmad=false -prec-div=true -ftz=false: the f32 cutoffs must
// give the JAX results bit for bit, and the f64 error rates the host
// engine's (walk.cuh).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "walk.cuh"

namespace {

using namespace lrsc::walk;

// argument arrays from the Python wrappers (ops/walk.py), in its order
struct Args {
  void* const* p;
  const int* d;
  int pi = 0, di = 0;
  template <class T>
  T ptr() { return reinterpret_cast<T>(p[pi++]); }
  int num() { return d[di++]; }
};

Index read_index(Args& a) {
  Index ix;
  ix.fb = a.ptr<const int8_t*>();
  ix.fck = a.ptr<const int*>();
  ix.fC = a.ptr<const int*>();
  ix.rb = a.ptr<const int8_t*>();
  ix.rck = a.ptr<const int*>();
  ix.rC = a.ptr<const int*>();
  ix.fnb = a.num();
  ix.rnb = a.num();
  ix.wcache = nullptr;
  return ix;
}

Cfg read_cfg(Args& a) {
  Cfg c;
  c.L = a.num();
  c.MAXLEN = a.num();
  c.QMAX = a.num();
  c.TMAX = a.num();
  c.RMAX = a.num();
  c.RING = a.num();
  c.KMAX = a.num();
  c.SS = a.num();
  c.MAXLEAVES = a.num();
  c.CK = a.num();
  c.SLAB = a.num();
  c.SB = a.num();
  c.NC = c.KMAX - c.CK + 1;
  return c;
}

Consts read_consts(Args& a) {
  Consts k;
  k.query = a.ptr<const int8_t*>();
  k.q_len = a.ptr<const int*>();
  k.trg = a.ptr<const int8_t*>();
  k.trg_len = a.ptr<const int*>();
  k.n_term = a.ptr<const int*>();
  k.term_f = a.ptr<const int*>();
  k.term_r = a.ptr<const int*>();
  k.qcode9 = a.ptr<const int*>();
  k.qcode5 = a.ptr<const int*>();
  k.init_k = a.ptr<const int*>();
  k.max_overlap = a.ptr<const int*>();
  k.min_overlap = a.ptr<const int*>();
  k.min_sa = a.ptr<const int*>();
  k.max_indel = a.ptr<const int*>();
  k.max_length = a.ptr<const int*>();
  k.min_length = a.ptr<const int*>();
  k.no_term = a.ptr<const bool*>();
  k.freqs = a.ptr<const float*>();
  k.redeem = a.ptr<const double*>();
  k.err_bound = a.ptr<const double*>();
  return k;
}

State read_state(Args& a) {
  State s;
  s.labels = a.ptr<int8_t*>();
  s.f_lo = a.ptr<int*>();
  s.f_hi = a.ptr<int*>();
  s.r_lo = a.ptr<int*>();
  s.r_hi = a.ptr<int*>();
  s.alive = a.ptr<bool*>();
  s.kmer_freq = a.ptr<int*>();
  s.total_kmer = a.ptr<int*>();
  s.last_seed_idx = a.ptr<int*>();
  s.last_overlap_len = a.ptr<int*>();
  s.total_seeds = a.ptr<int*>();
  s.curr_overlap_len = a.ptr<int*>();
  s.num_errors = a.ptr<int*>();
  s.seed_idx_offset = a.ptr<int*>();
  s.query_overlap_len = a.ptr<int*>();
  s.nrs = a.ptr<double*>();
  s.res_first = a.ptr<int*>();
  s.res_second = a.ptr<int*>();
  s.tail_letter = a.ptr<int8_t*>();
  s.tail_count = a.ptr<int*>();
  s.tail9 = a.ptr<int*>();
  s.tail8 = a.ptr<int*>();
  s.chain = a.ptr<int*>();
  s.local_err = a.ptr<double*>();
  s.gerr_last = a.ptr<double*>();
  s.ring = a.ptr<double*>();
  s.active = a.ptr<bool*>();
  s.cur_len = a.ptr<int*>();
  s.cur_k = a.ptr<int*>();
  s.gerr_n = a.ptr<int*>();
  s.code = a.ptr<int*>();
  s.res_labels = a.ptr<int8_t*>();
  s.res_len = a.ptr<int*>();
  s.res_err = a.ptr<double*>();
  s.res_i = a.ptr<int*>();
  s.res_count = a.ptr<int*>();
  s.res_overflow = a.ptr<bool*>();
  s.res_tie = a.ptr<bool*>();
  return s;
}

Reduced read_reduced(Args& a) {
  Reduced r;
  r.code = a.ptr<int*>();
  r.overflow = a.ptr<bool*>();
  r.has = a.ptr<bool*>();
  r.lab = a.ptr<int8_t*>();
  r.len = a.ptr<int*>();
  r.i = a.ptr<int*>();
  r.tie = a.ptr<bool*>();
  return r;
}

Root read_root(Args& a) {
  Root r;
  r.f_lo = a.ptr<const int*>();
  r.f_hi = a.ptr<const int*>();
  r.r_lo = a.ptr<const int*>();
  r.r_hi = a.ptr<const int*>();
  r.freq = a.ptr<const int*>();
  r.chain0 = a.ptr<const int*>();
  r.tail9 = a.ptr<const int*>();
  r.tail8 = a.ptr<const int*>();
  r.tail_letter = a.ptr<const int8_t*>();
  r.tail_count = a.ptr<const int*>();
  return r;
}

// ---------------------------------------------------------------------------

// the parent code thread g visits (see the note above): its last
// kLevelRun bases those of g, the k - kLevelRun before them the base-4
// digits of the rest of g in reverse order
constexpr int kLevelRun = 2;
__device__ __forceinline__ int level_up_parent(int g, int k) {
  if (k <= kLevelRun) return g;
  int m = g >> (2 * kLevelRun), code = 0;
  for (int d = kLevelRun; d < k; ++d) {
    code = (code << 2) | (m & 3);
    m >>= 2;
  }
  return (code << (2 * kLevelRun)) | (g & ((1 << (2 * kLevelRun)) - 1));
}

__global__ void wcache_level_up_kernel(Index ix, int n, int k, const int* __restrict__ f_lo,
                                       const int* __restrict__ f_hi,
                                       const int* __restrict__ r_lo,
                                       const int* __restrict__ r_hi, int4* o0, int4* o1,
                                       int4* o2, int4* o3) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int p = level_up_parent(g, k);
  // child 4p + c - 1 appends base c: the RBWT step by c, the BWT step by
  // comp(c) = 5 - c
  int a[4], z[4], u[4], w[4];
  lrsc::occ_acgt_pair(ix.fb, ix.fck, ix.fC, ix.fnb, __ldg(f_lo + p), __ldg(f_hi + p), a, z);
  lrsc::occ_acgt_pair(ix.rb, ix.rck, ix.rC, ix.rnb, __ldg(r_lo + p), __ldg(r_hi + p), u, w);
  int pf[4], pr[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    pf[c] = __ldg(ix.fC + c + 1);
    pr[c] = __ldg(ix.rC + 4 - c);
  }
  o0[p] = make_int4(pf[0] + a[0], pf[1] + a[1], pf[2] + a[2], pf[3] + a[3]);
  o1[p] = make_int4(pf[0] + z[0] - 1, pf[1] + z[1] - 1, pf[2] + z[2] - 1, pf[3] + z[3] - 1);
  o2[p] = make_int4(pr[0] + u[3], pr[1] + u[2], pr[2] + u[1], pr[3] + u[0]);
  o3[p] = make_int4(pr[0] + w[3] - 1, pr[1] + w[2] - 1, pr[2] + w[1] - 1, pr[3] + w[0] - 1);
}

constexpr int kPrepWarps = 4;  // tasks per block, one warp each

__global__ void __launch_bounds__(kPrepWarps * 32)
    walk_prep_kernel(Index ix, PrepIn P, PrepOut O, int T) {
  extern __shared__ int4 prep_smem[];
  const int w = threadIdx.x >> 5, t = blockIdx.x * kPrepWarps + w;
  if (t >= T) return;
  int8_t* rows = reinterpret_cast<int8_t*>(prep_smem) +
                 (size_t)w * prep_row_bytes(P.QMAX, P.TMAX, P.KMAX);
  prep_task(ix, P, O, t, threadIdx.x & 31, rows);
}

constexpr int kMaxWarps = 4;  // warps (gap lanes) per block
// blocks an SM should hold: at L = 4 the shared memory allows 5 blocks of
// 4 lanes at the main config, and telling ptxas so (at most 102 registers
// a thread) is what keeps it from spilling; at L = 32 a lane needs tens of
// KB, and one block an SM is what fits
template <int LM>
constexpr int kMinBlocks = LM <= 4 ? 5 : 1;

__device__ __forceinline__ char* dyn_smem() {
  extern __shared__ int4 walk_smem[];
  return reinterpret_cast<char*>(walk_smem);
}

template <int LM>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks<LM>)
    walk_steps_kernel(Index ix, Cfg cf, Consts K, State S, Reduced R, int G, int n,
                      int lane_bytes) {
  const int w = threadIdx.x >> 5, g = blockIdx.x * (blockDim.x >> 5) + w;
  if (g >= G) return;
  Walker<LM> walker(ix, cf, K, dyn_smem() + (size_t)w * lane_bytes);
  walker.load_task(g);
  if (S.active[g] && S.code[g] == 0) {
    walker.load(S, g);
    for (int s = 0; s < n && walker.active && walker.code == 0; ++s) walker.step();
    walker.store(S, g);
  }
  walker.reduce_state(S, g, R, g);
}

template <int LM>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks<LM>)
    walk_queue_kernel(Index ix, Cfg cf, Consts K, Reduced R, Root RT, int* head,
                      int max_steps, int n, int lane_bytes) {
  const int w = threadIdx.x >> 5;
  Walker<LM> walker(ix, cf, K, dyn_smem() + (size_t)w * lane_bytes);
  for (;;) {
    int t = 0;
    if (walker.lane == 0) t = atomicAdd(head, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= n) break;
    walker.load_task(t);
    walker.seed(RT);
    for (int s = 0; s < max_steps && walker.code == 0; ++s) walker.step();
    if (walker.code == 0) walker.code = -900;
    walker.reduce_smem(R, t);
    __syncwarp();
  }
}

// Launch geometry of a walk kernel from the plan the wrapper passes (the
// bytes of one lane's shared memory, lanes per block), checked against
// this file's own layout; info: [blocks per SM, warps per block, blocks,
// shared bytes per block].  0 or a CUDA error.
template <class Kern>
int geometry(Kern kern, const Cfg& cf, int lane_bytes, int warps, int lanes, int* info,
             int& blocks, bool persistent) {
  if (cf.L < 1 || cf.L > 32 || cf.RMAX > 64 || cf.MAXLEN >= (1 << 16) ||
      cf.QMAX >= (1 << 16) || warps < 1 || warps > kMaxWarps ||
      lane_layout(cf).total != lane_bytes)
    return (int)cudaErrorInvalidValue;
  const int smem = warps * lane_bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, warps * 32, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  blocks = (lanes + warps - 1) / warps;
  if (persistent) blocks = std::min(blocks, per_sm * sms);
  info[0] = per_sm;
  info[1] = warps;
  info[2] = blocks;
  info[3] = smem;
  return 0;
}

template <int LM>
int launch_steps(Index ix, Cfg cf, Consts K, State S, Reduced R, int G, int n,
                 int lane_bytes, int warps, int* info, cudaStream_t st) {
  int blocks = 0;
  const int rc = geometry(walk_steps_kernel<LM>, cf, lane_bytes, warps, G, info, blocks, false);
  if (rc != 0) return rc;
  walk_steps_kernel<LM><<<blocks, warps * 32, warps * lane_bytes, st>>>(ix, cf, K, S, R, G, n,
                                                                        lane_bytes);
  return (int)cudaGetLastError();
}

template <int LM>
int launch_queue(Index ix, Cfg cf, Consts K, Reduced R, Root RT, int* head, int max_steps,
                 int n, int lane_bytes, int warps, int* info, cudaStream_t st) {
  int blocks = 0;
  const int rc = geometry(walk_queue_kernel<LM>, cf, lane_bytes, warps, n, info, blocks, true);
  if (rc != 0) return rc;
  walk_queue_kernel<LM><<<blocks, warps * 32, warps * lane_bytes, st>>>(
      ix, cf, K, R, RT, head, max_steps, n, lane_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry takes a host array of device pointers and a host array of
// ints, in the order ops/walk.py builds them, and the stream.
// n = 4^k parents of level k (1 <= k <= 15)
extern "C" int lrsc_wcache_level_up(void* const* p, const int* d, void* stream) {
  Args a{p, d};
  Index ix = read_index(a);
  const int* f_lo = a.ptr<const int*>();
  const int* f_hi = a.ptr<const int*>();
  const int* r_lo = a.ptr<const int*>();
  const int* r_hi = a.ptr<const int*>();
  int4* o[4];
  for (int q = 0; q < 4; ++q) o[q] = a.ptr<int4*>();
  const int n = a.num();
  const int k = a.num();
  if (k < 1 || k > 15 || n != 1 << (2 * k)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  wcache_level_up_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      ix, n, k, f_lo, f_hi, r_lo, r_hi, o[0], o[1], o[2], o[3]);
  return (int)cudaGetLastError();
}

extern "C" int lrsc_walk_prep(void* const* p, const int* d, void* stream) {
  Args a{p, d};
  Index ix = read_index(a);
  PrepIn P;
  P.query = a.ptr<const int8_t*>();
  P.q_len = a.ptr<const int*>();
  P.trg = a.ptr<const int8_t*>();
  P.n_term = a.ptr<const int*>();
  P.init_k = a.ptr<const int*>();
  P.min_overlap = a.ptr<const int*>();
  ix.wcache = a.ptr<const int*>();
  PrepOut O;
  O.qcode9 = a.ptr<int*>();
  O.qcode5 = a.ptr<int*>();
  O.term_f = a.ptr<int*>();
  O.term_r = a.ptr<int*>();
  O.f_lo = a.ptr<int*>();
  O.f_hi = a.ptr<int*>();
  O.r_lo = a.ptr<int*>();
  O.r_hi = a.ptr<int*>();
  O.freq = a.ptr<int*>();
  O.chain0 = a.ptr<int*>();
  O.tail9 = a.ptr<int*>();
  O.tail8 = a.ptr<int*>();
  O.tail_letter = a.ptr<int8_t*>();
  O.tail_count = a.ptr<int*>();
  const int T = a.num();
  P.QMAX = a.num();
  P.TMAX = a.num();
  P.KMAX = a.num();
  P.CK = a.num();
  P.SS = a.num();
  P.kb_term = a.num();
  P.kb_root = a.num();
  P.use_wcache = a.num();
  P.table = a.num();
  P.parts = a.num();
  if (P.CK < 1 || P.CK > 15 || P.kb_term > P.KMAX + 1 || (P.use_wcache && !P.table))
    return (int)cudaErrorInvalidValue;
  const int smem = kPrepWarps * prep_row_bytes(P.QMAX, P.TMAX, P.KMAX);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        walk_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (T > 0)
    walk_prep_kernel<<<(T + kPrepWarps - 1) / kPrepWarps, kPrepWarps * 32, smem,
                       (cudaStream_t)stream>>>(ix, P, O, T);
  return (int)cudaGetLastError();
}

extern "C" int lrsc_walk_steps(void* const* p, const int* d, int* info, void* stream) {
  Args a{p, d};
  Index ix = read_index(a);
  ix.wcache = a.ptr<const int*>();
  Consts K = read_consts(a);
  State S = read_state(a);
  Reduced R = read_reduced(a);
  Cfg cf = read_cfg(a);
  const int G = a.num(), n = a.num(), lane_bytes = a.num(), warps = a.num();
  if (G == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return cf.L <= 4 ? launch_steps<4>(ix, cf, K, S, R, G, n, lane_bytes, warps, info, st)
                   : launch_steps<32>(ix, cf, K, S, R, G, n, lane_bytes, warps, info, st);
}

extern "C" int lrsc_walk_queue(void* const* p, const int* d, int* info, void* stream) {
  Args a{p, d};
  Index ix = read_index(a);
  ix.wcache = a.ptr<const int*>();
  Consts K = read_consts(a);
  Reduced R = read_reduced(a);
  Root RT = read_root(a);
  int* head = a.ptr<int*>();
  Cfg cf = read_cfg(a);
  const int max_steps = a.num(), n = a.num(), lane_bytes = a.num(), warps = a.num();
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return cf.L <= 4
             ? launch_queue<4>(ix, cf, K, R, RT, head, max_steps, n, lane_bytes, warps, info, st)
             : launch_queue<32>(ix, cf, K, R, RT, head, max_steps, n, lane_bytes, warps, info, st);
}
