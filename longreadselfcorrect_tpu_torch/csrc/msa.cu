// The MSA/DP fallback's two kernels, replacing the JAX package's
// ops/msa_kernels.py device functions.
//
// * lf_extract (msa_kernels.py:36 _lf_extract_jit): for each root row,
//   up to its group's max_steps dependent LF steps; a row parks at '$'
//   (symbol 0) and writes zeros from there on.  One launch serves a whole
//   multiple alignment: up to four groups of rows (the two seeds' k-mers,
//   each on both BWTs of one IndexSet), each with its own index and step
//   count.  Bound on the H100: the chain.  Every step is a random 128-byte
//   index row plus its 20-byte checkpoint row, in an index far larger than
//   the 50 MB L2, and each step depends on the last, so a launch lasts its
//   longest row's steps x one memory latency, whatever the row count (the
//   byte bound, ~150 B a step, is 10^4 times shorter).  The symbol at idx
//   and the rank of it before idx read the same block row (occ(b, idx-1)
//   reads row idx >> 7), so a step is one load round: a warp per row, lane
//   i loads word i of the row (the 128 bytes as one coalesced request) and
//   lanes 0-4 the checkpoint row, all at once; the symbol comes from the
//   lane holding byte r by a shuffle, each lane counts it in its own word
//   (__vcmpeq4 / __popc, rank.cuh's count_word, masked to the first r
//   bytes) and a warp reduce sums them; the checkpoint count and C[b]
//   come from lanes b by shuffles.  One thread per row, counting the 32
//   words itself, spent more time in that serial count than in the load.
// * banded_fill (msa_kernels.py:89 _banded_fill_jit): the banded cell fill
//   of extend_match for N (query, candidate) lanes, one block per lane and
//   one thread per band slot.  The columns stay sequential; the previous
//   column sits in shared memory (diag = slot k, left = slot k + 1), and
//   the up-chain curr[k] = max(base[k], curr[k-1] + gap) is a block-wide
//   inclusive max-scan of base[k] - k * gap (warp shuffles, then the warp
//   totals), reset outside the band.  Bound: the int32 cells written,
//   N * (Q + 1) * bw * 4 bytes; the three barriers of each column make a
//   launch last about Q column steps.
//
// Characters are compared as given (query pad 0, target pad -1), so a
// lane's cells equal the host fill_cells (core/overlapper.py) cell for
// cell on every column its query has.
#include <cuda_runtime.h>

#include <cstdint>

#include "rank.cuh"

namespace {

constexpr int kInvalid = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;

struct LfIndex {
  const int8_t* blocks;  // [nb, 128]
  const int* ckpt;       // [nb, 5]
  const int* C;          // [6]
  int nb;
};

constexpr int kLfMaxGroups = 4;
constexpr int kLfWarps = 4;  // rows per block

struct LfGroups {
  int which[kLfMaxGroups];  // 0: the first index, 1: the second
  int steps[kLfMaxGroups];  // max_steps of the group
};

// one warp per row
__global__ void lf_extract_kernel(LfIndex ix0, LfIndex ix1,
                                  const int* __restrict__ roots,
                                  const int8_t* __restrict__ group, int N, LfGroups g,
                                  int S, int8_t* __restrict__ out,
                                  int* __restrict__ lens) {
  const int n = blockIdx.x * kLfWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // the whole warp
  const int gi = group[n];
  const LfIndex fm = g.which[gi] ? ix1 : ix0;
  const int max_steps = g.steps[gi];
  const int c_lane = lane < 6 ? __ldg(fm.C + lane) : 0;  // C[lane]
  int8_t* row = out + (size_t)n * S;
  int idx = roots[n];
  int s = 0;
  for (; s < max_steps; ++s) {
    // one load round: word `lane` of the block row of idx, and the row's
    // checkpoint counts on lanes 0-4
    const int q = min(idx >> 7, fm.nb - 1);
    const int r = idx - ((idx >> 7) << 7);
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(
                                 fm.blocks + (size_t)q * lrsc::kBlock) + lane);
    const int ck = lane < 5 ? __ldg(fm.ckpt + (size_t)q * 5 + lane) : 0;
    // the symbol at idx: byte r of the row
    const int b = (int)((__shfl_sync(kFull, w, r >> 2) >> (8 * (r & 3))) & 0xffu);
    if (b == 0) break;
    if (lane == 0) row[s] = (int8_t)b;
    // occ(b, idx - 1): b's count before the row plus its count in row[0:r]
    const int cnt = (int)__reduce_add_sync(
        kFull, (unsigned)lrsc::count_word(w, 0x01010101u * (unsigned)b, r - 4 * lane));
    idx = __shfl_sync(kFull, c_lane, b) + __shfl_sync(kFull, ck, b) + cnt;
  }
  if (lane == 0) lens[n] = s;
  for (int z = s + lane; z < S; z += 32) row[z] = 0;
}

__device__ __forceinline__ int warp_max_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

// cells[n, i, k] = DP(i, j = origin[n] + i + k) for i in 0..Q, k < bw.
__global__ void banded_fill_kernel(const int8_t* __restrict__ q,
                                   const int8_t* __restrict__ t,
                                   const int* __restrict__ t_len,
                                   const int* __restrict__ origin, int Q, int T,
                                   int bw, int match, int gap, int mismatch,
                                   int* __restrict__ cells) {
  extern __shared__ int smem[];
  int* wsum = smem;                 // [32] inclusive warp totals
  int* prev = smem + 32;            // [bw] the previous column
  int* curr = prev + bw;            // [bw]
  const int n = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5, nwarps = blockDim.x >> 5;
  const int8_t* qn = q + (size_t)n * Q;
  const int8_t* tn = t + (size_t)n * T;
  int* out = cells + (size_t)n * (Q + 1) * bw;
  const int tl = t_len[n];
  const int org = origin[n];

  if (k < bw) {
    prev[k] = 0;
    out[k] = 0;
  }
  __syncthreads();
  for (int i = 1; i <= Q; ++i) {
    const int j0 = org + i;
    const int row = j0 + k;
    // the in-band slots are the rows 1..tl of the band: lo..hi
    const int lo = max(1 - j0, 0);
    const int hi = min(tl - j0, bw - 1);
    const bool in_band = k < bw && k >= lo && k <= hi;
    int v = kInvalid;
    if (in_band) {
      const int sub = __ldg(tn + row - 1) == __ldg(qn + i - 1) ? match : mismatch;
      const int diag = prev[k] + sub;
      int base = diag;
      // the last in-band row of the column has no left predecessor
      if (!(hi > lo && k == hi)) {
        const int left = k + 1 < bw ? prev[k + 1] + gap : kInvalid;
        base = max(diag, left);
      }
      v = base - k * gap;
    }
    v = warp_max_scan(v, lane);
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? wsum[lane] : kInvalid;
      w = warp_max_scan(w, lane);
      wsum[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v = max(v, wsum[warp - 1]);
    if (k < bw) {
      const int c = in_band ? v + k * gap : 0;
      curr[k] = c;
      out[(size_t)i * bw + k] = c;
    }
    __syncthreads();
    int* tmp = prev;
    prev = curr;
    curr = tmp;
  }
}

}  // namespace

// groups: host int[G * 2], (which index, max_steps) per group; group:
// the group of each row; S >= every group's max_steps (the row stride).
extern "C" int lrsc_lf_extract(const int8_t* blocks0, const int* ckpt0, const int* C0,
                               int nb0, const int8_t* blocks1, const int* ckpt1,
                               const int* C1, int nb1, const int* roots,
                               const int8_t* group, int N, const int* groups, int G,
                               int S, int8_t* out, int* lens, void* stream) {
  if (G < 1 || G > kLfMaxGroups) return (int)cudaErrorInvalidValue;
  LfGroups g{};
  for (int i = 0; i < G; ++i) {
    g.which[i] = groups[2 * i];
    g.steps[i] = groups[2 * i + 1];
    if (g.which[i] < 0 || g.which[i] > 1 || g.steps[i] < 0 || g.steps[i] > S)
      return (int)cudaErrorInvalidValue;
  }
  if (N > 0) {
    lf_extract_kernel<<<(N + kLfWarps - 1) / kLfWarps, 32 * kLfWarps, 0,
                        (cudaStream_t)stream>>>(
        LfIndex{blocks0, ckpt0, C0, nb0}, LfIndex{blocks1, ckpt1, C1, nb1}, roots, group,
        N, g, S, out, lens);
  }
  return (int)cudaGetLastError();
}

extern "C" int lrsc_banded_fill(const int8_t* q, const int8_t* t, const int* t_len,
                                const int* origin, int N, int Q, int T, int bw,
                                int match, int gap, int mismatch, int* cells,
                                void* stream) {
  if (bw < 1 || bw > 1024) return (int)cudaErrorInvalidValue;
  const int threads = 32 * ((bw + 31) / 32);
  const size_t shmem = sizeof(int) * (32 + 2 * bw);
  if (N > 0) {
    banded_fill_kernel<<<N, threads, shmem, (cudaStream_t)stream>>>(
        q, t, t_len, origin, Q, T, bw, match, gap, mismatch, cells);
  }
  return (int)cudaGetLastError();
}
