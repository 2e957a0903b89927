// The MSA/DP fallback's two kernels, replacing the JAX package's
// ops/msa_kernels.py device functions.
//
// * lf_extract (msa_kernels.py:36 _lf_extract_jit): one thread per SA row
//   walks up to max_steps dependent LF steps; a row parks at '$' (symbol
//   0) and writes zeros from there on.  Bound on the H100: every step is a
//   random 128-byte index row (the symbol at the row and the rank of it
//   before the row share one row) plus a checkpoint word, in an index far
//   larger than the 50 MB L2; each step depends on the last, so a launch
//   lasts about max_steps dependent loads whatever the row count.
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

__global__ void lf_extract_kernel(const int8_t* __restrict__ blocks,
                                  const int* __restrict__ ckpt,
                                  const int* __restrict__ C, int nb,
                                  const int* __restrict__ roots, int N,
                                  int max_steps, int8_t* __restrict__ out,
                                  int* __restrict__ lens) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int8_t* row = out + (size_t)n * max_steps;
  int idx = roots[n];
  int s = 0;
  for (; s < max_steps; ++s) {
    const int b = __ldg(blocks + idx);  // blocks is [nb, 128] row-major
    if (b == 0) break;
    row[s] = (int8_t)b;
    idx = __ldg(C + b) + lrsc::occ(blocks, ckpt, nb, b, idx - 1);
  }
  lens[n] = s;
  for (int z = s; z < max_steps; ++z) row[z] = 0;
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

extern "C" int lrsc_lf_extract(const int8_t* blocks, const int* ckpt, const int* C,
                               int nb, const int* roots, int N, int max_steps,
                               int8_t* out, int* lens, void* stream) {
  const int threads = 128;
  if (N > 0) {
    lf_extract_kernel<<<(N + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(blocks, ckpt, C, nb, roots, N,
                                                max_steps, out, lens);
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
