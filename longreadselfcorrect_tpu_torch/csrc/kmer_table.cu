// kmer_table_full: freq + validity of the k-mer at every (read, pos) lane
// for every k in 0..max_k, from one bi-interval LF ladder per lane.
//
// Replaces ops/scan.py:108 kmer_table_full of the JAX package (with its
// fused-row occ, :83 _occ_fusedrow / :102 _update_fusedrow).
//
// Bound on the H100: random reads into the index.  Each live step of a
// lane extends the fwd interval on the RBWT and the rvc interval on the
// BWT: four rank queries, each one 128-byte symbol row plus one checkpoint
// word, into two ~140 MB tables at the bench scale, which the 50 MB L2
// cannot hold.  Then the table writes: (max_k + 1) * R * L * 5 bytes.
//
// Design: one thread per lane holds its four interval ends in registers
// and walks k = 1..max_k, so the only memory traffic is the rank rows and
// the coalesced table writes (consecutive threads = consecutive positions).
// Blocks and checkpoints stay two arrays, not one fused row as on the TPU:
// the TPU fused them to save a gather per query, while here a query reads
// the checkpoint word as one extra 32-byte sector either way, and a fused
// copy would double the index's device memory.
// A strand whose interval became invalid (lo > hi) stays invalid with size
// 0 under the LF math, so its rank queries are skipped: the outputs are
// those of the JAX ladder, which keeps updating it.
// Row 0 is the JAX table's constant level 0 (freq -1, valid false).
#include <cuda_runtime.h>

#include <cstdint>

#include "rank.cuh"

namespace {

__global__ void kmer_table_full_kernel(
    const int8_t* __restrict__ f_blocks, const int* __restrict__ f_ckpt,
    const int* __restrict__ f_C, int f_nb, const int8_t* __restrict__ r_blocks,
    const int* __restrict__ r_ckpt, const int* __restrict__ r_C, int r_nb,
    const int8_t* __restrict__ reads, const int* __restrict__ lens, int R, int L,
    int max_k, int* __restrict__ freq, bool* __restrict__ valid) {
  const size_t plane = (size_t)R * L;
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= plane) return;
  const int r = (int)(lane / L);
  const int p = (int)(lane - (size_t)r * L);
  const int8_t* row = reads + (size_t)r * L;
  const int len = lens[r];

  const int s0 = min(max((int)row[p], 0), 4);
  int f_lo = __ldg(f_C + s0), f_hi = __ldg(f_C + s0 + 1) - 1;
  const int c0 = lrsc::comp(s0);
  int r_lo = __ldg(r_C + c0), r_hi = __ldg(r_C + c0 + 1) - 1;

  freq[lane] = -1;
  valid[lane] = false;
  for (int j = 1; j <= max_k; ++j) {
    const bool fake = p + j > len;
    const int size = max(f_hi - f_lo + 1, 0) + max(r_hi - r_lo + 1, 0);
    freq[j * plane + lane] = fake ? -1 : size;
    valid[j * plane + lane] = !fake && f_lo <= f_hi && r_lo <= r_hi;
    if (j == max_k) break;
    const int nxt = p + j < L ? (int)row[p + j] : lrsc::kPadRank;
    if (nxt >= lrsc::kPadRank) continue;  // past the read: state frozen
    const int s = max(nxt, 0);
    if (f_lo <= f_hi)
      lrsc::update_interval(f_blocks, f_ckpt, f_C, f_nb, s, f_lo, f_hi);
    if (r_lo <= r_hi)
      lrsc::update_interval(r_blocks, r_ckpt, r_C, r_nb, lrsc::comp(s), r_lo, r_hi);
  }
}

}  // namespace

extern "C" int lrsc_kmer_table_full(const int8_t* f_blocks, const int* f_ckpt,
                                    const int* f_C, int f_nb, const int8_t* r_blocks,
                                    const int* r_ckpt, const int* r_C, int r_nb,
                                    const int8_t* reads, const int* lens, int R,
                                    int L, int max_k, int* freq, bool* valid,
                                    void* stream) {
  const size_t lanes = (size_t)R * L;
  const int threads = 256;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  if (blocks > 0) {
    kmer_table_full_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        f_blocks, f_ckpt, f_C, f_nb, r_blocks, r_ckpt, r_C, r_nb, reads, lens, R,
        L, max_k, freq, valid);
  }
  return (int)cudaGetLastError();
}
