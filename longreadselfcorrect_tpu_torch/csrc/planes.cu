// The bit-plane seed table: the index as bit-plane rows, and the k-mer
// table counted on them with its ladder seeded at k = ck.
//
// Replaces, from the JAX package's ops/scan.py:
//   _build_plane_rows (:212, via :225 build_planes): blocks int8 [nb, 128]
//     and ckpt int32 [nb, 5] -> int32 [nb, 17] rows (planes.cuh);
//   kmer_table_planes (:276): kmer_table_full's freq int32 / valid bool
//     [max_k+1, R, L], the state at level ck read from the walk's ck-mer
//     interval table (wcache [4^ck, 4]: f_lo, f_hi, r_lo, r_hi), levels
//     ck..max_k walked on the plane rows; rows 0..ck-1 are -1 / false.
//
// plane_rows is bound by bytes: each block row (128 symbols + 20 bytes of
// checkpoints) read once and its 68-byte row written once.  One thread per
// (block, word) loads its 32 symbols as two 16-byte vectors and builds the
// three words in registers.
//
// kmer_table_planes is bound, like kmer_table_full, by random rank rows,
// here 68 bytes each (planes.cuh), over 12 fewer levels, plus one 16-byte
// wcache entry per lane.  One thread per lane (ladder.cuh): the lane packs
// reads[p : p+ck] as 2-bit codes, first char most significant, with chars
// past the row as code 0 and everything outside 1..4 clipped into it, as
// ops/scan.py:294-297 does (so an N, rank 0, counts as A there).  At 32
// registers a thread every lane of a chunk is resident at once, and the
// time is each lane's chain of dependent rank loads: the kmer_table_wire
// kernel's compacted lane list (lane_list.cuh) and a both-strand step that
// reads one row for both ends (96 registers) were measured on this kernel
// and lost to it (PERF.md §6 row 8b, tools/prof_tables.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "ladder.cuh"
#include "planes.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void plane_rows_kernel(const int8_t* __restrict__ blocks,
                                  const int* __restrict__ ckpt, int nb,
                                  int* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)nb * lrsc::kPlaneWords) return;
  const size_t q = t / lrsc::kPlaneWords;
  const int w = (int)(t - q * lrsc::kPlaneWords);
  const uint4* src =
      reinterpret_cast<const uint4*>(blocks + q * lrsc::kBlock + 32 * w);
  const uint4 a = __ldg(src), b = __ldg(src + 1);
  const unsigned x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned plane[3] = {0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned sym = x[j >> 2] >> (8 * (j & 3));  // little-endian bytes
#pragma unroll
    for (int i = 0; i < 3; ++i) plane[i] |= ((sym >> i) & 1u) << j;
  }
  int* o = out + q * lrsc::kPlaneRow;
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i * lrsc::kPlaneWords + w] = (int)plane[i];
  const int* ck = ckpt + q * 5;
  o[3 * lrsc::kPlaneWords + w] = ck[w];
  if (w == lrsc::kPlaneWords - 1) o[3 * lrsc::kPlaneWords + 4] = ck[4];
}

__global__ void kmer_table_planes_kernel(lrsc::PlaneRank fwd, lrsc::PlaneRank rev,
                                         const int4* __restrict__ wcache, int ck,
                                         const int8_t* __restrict__ reads,
                                         const int* __restrict__ lens, int R, int L,
                                         int max_k, int* __restrict__ freq,
                                         bool* __restrict__ valid) {
  const size_t plane = (size_t)R * L;
  const size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= plane) return;
  const int r = (int)(lane / L);
  const int p = (int)(lane - (size_t)r * L);
  const int8_t* row = reads + (size_t)r * L;

  const unsigned mask = (1u << (2 * ck)) - 1u;
  unsigned code = 0;
  for (int j = 0; j < ck; ++j) {
    const int c = p + j < L ? (int)row[p + j] : 1;
    code = ((code << 2) | (unsigned)(min(max(c, 1), 4) - 1)) & mask;
  }
  const int4 w = __ldg(wcache + code);

  for (int j = 0; j < ck; ++j) {
    freq[j * plane + lane] = -1;
    valid[j * plane + lane] = false;
  }
  lrsc::ladder(fwd, rev, row, p, L, lens[r], ck, max_k,
               lrsc::BiInterval{w.x, w.y, w.z, w.w},
               [&](int j, bool fake, const lrsc::BiInterval& s) {
                 freq[j * plane + lane] = fake ? -1 : s.size();
                 valid[j * plane + lane] = !fake && s.valid();
               });
}

}  // namespace

// blocks: 16-byte aligned [nb, 128]; out: [nb, 17].
extern "C" int lrsc_plane_rows(const int8_t* blocks, const int* ckpt, int nb, int* out,
                               void* stream) {
  const size_t threads = (size_t)nb * lrsc::kPlaneWords;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  if (grid > 0) {
    plane_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(blocks, ckpt, nb, out);
  }
  return (int)cudaGetLastError();
}

// wcache: 16-byte aligned [4^ck, 4]; 1 <= ck <= min(max_k, 15).
extern "C" int lrsc_kmer_table_planes(const int* f_prows, const int* f_C, int f_nb,
                                      const int* r_prows, const int* r_C, int r_nb,
                                      const int* wcache, int ck, const int8_t* reads,
                                      const int* lens, int R, int L, int max_k,
                                      int* freq, bool* valid, void* stream) {
  if (ck < 1 || ck > 15 || ck > max_k) return (int)cudaErrorInvalidValue;
  const size_t lanes = (size_t)R * L;
  const unsigned grid = (unsigned)((lanes + kThreads - 1) / kThreads);
  if (grid > 0) {
    kmer_table_planes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        lrsc::PlaneRank{f_prows, f_C, f_nb}, lrsc::PlaneRank{r_prows, r_C, r_nb},
        reinterpret_cast<const int4*>(wcache), ck, reads, lens, R, L, max_k, freq,
        valid);
  }
  return (int)cudaGetLastError();
}
