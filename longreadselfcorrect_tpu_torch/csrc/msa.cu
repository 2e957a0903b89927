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
//   of extend_match for N (query, candidate) lanes.  Bound on the H100:
//   the chain of Q dependent columns, not the bytes (the int32 cells
//   written once, N * (Q + 1) * bw * 4 bytes, take ~1 us).  So a column
//   is kept short: one warp per lane, four lanes a block, no block
//   barrier.  Thread `lane` holds the S = ceil(bw / 32) consecutive slots
//   k = lane * S + s of the column in registers; diag is its own slot k,
//   left its slot k + 1 (for its last slot the next lane's slot 0, which it
//   computes itself from that slot's value before the fix-up, fetched by
//   one __shfl_down beside the scan), except on the column's last in-band
//   row when the band holds more than one row.  The up-chain curr[k] =
//   max(base[k], curr[k-1] + gap) is an inclusive max-scan of base[k] - k
//   * gap, reset outside the band: a running max over the thread's S
//   slots, a 5-round __shfl_up exclusive max-scan of the thread totals,
//   and that prefix folded into each slot: five dependent shuffles a
//   column.  A slot keeps its value in that scan's domain,
//   and the target bytes slide one slot down a column in registers, so a
//   slot's step is a few adds, compares and selects, no branch and no
//   load.  Each thread stores its own slots: measured on the H100
//   (PERF.md), that beat a shared-memory transpose that writes every
//   32-byte sector once, and strided slot ownership (one scan per slot
//   row).
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

// exclusive max-scan over the warp: the max of t over the lanes below
// this one (kInvalid on lane 0), in five dependent shuffle rounds.  The
// first round takes the two lanes below at once; from then on a lane
// below d gets its own value back from __shfl_up, and max(y, y) = y.
__device__ __forceinline__ int warp_max_before(int t, int lane) {
  const int a = __shfl_up_sync(kFull, t, 1), b = __shfl_up_sync(kFull, t, 2);
  int y = max(lane >= 1 ? a : kInvalid, lane >= 2 ? b : kInvalid);
#pragma unroll
  for (int d = 2; d < 32; d <<= 1) y = max(y, __shfl_up_sync(kFull, y, d));
  return y;
}

constexpr int kFillWarps = 4;  // DP lanes per block, one warp each

// cells[n, i, k] = DP(i, j = origin[n] + i + k) for i in 0..Q, k < bw;
// S slots a thread, 32 * S >= bw (slots from bw on are out of band).
//
// A slot keeps P = cell - k * gap, the domain of the up-chain's scan:
// then diag is P[k] + sub and left P[k + 1] + 2 * gap with no per-slot
// product, an out-of-band slot holds -k * gap (cell 0), and the cell
// written is P + k * gap.  Slot k of column i compares query byte i - 1
// with target byte org + i + k - 1, which is slot k + 1's byte of the
// column before: the bytes slide down one slot a column (the last slot
// takes the next lane's first by a shuffle; lane 31's, past the band
// unless 32 * S == bw, is loaded a column ahead).
template <int S>
__global__ void __launch_bounds__(kFillWarps * 32)
    banded_fill_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                       const int* __restrict__ t_len, const int* __restrict__ origin,
                       int N, int Q, int T, int bw, int match, int gap, int mismatch,
                       int* __restrict__ cells) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kFillWarps + w;
  if (n >= N) return;  // the whole warp
  const int8_t* qn = q + (size_t)n * Q;
  const int8_t* tn = t + (size_t)n * T;
  int* out = cells + (size_t)n * (Q + 1) * bw;
  const int tl = t_len[n], org = origin[n];
  const int k0 = lane * S, gap2 = 2 * gap;
  // slot k1 = k0 + S, the next lane's first: its value, kept from the
  // column before (the zero column: -k1 * gap)
  const int k1 = k0 + S, kg1 = k1 * gap;
  int next0 = -kg1;
  int P[S], kg[S], tc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    kg[s] = (k0 + s) * gap;
    P[s] = -kg[s];
    // column 1's bytes (clamped into the row, as the plain version's
    // gather; only in-band slots use them)
    tc[s] = tn[min(max(org + k0 + s, 0), T - 1)];
  }
  for (int k = lane; k < bw; k += 32) out[k] = 0;
  // lane 31's next byte, a column ahead
  int t31 = lane == 31 ? tn[min(max(org + 1 + k0 + S - 1, 0), T - 1)] : 0;
  int qc = Q > 0 ? qn[0] : 0;
  for (int i = 1; i <= Q; ++i) {
    const int qc_next = i < Q ? qn[i] : 0;
    const int t31_next = lane == 31 ? tn[min(max(org + i + 1 + k0 + S - 1, 0), T - 1)] : 0;
    const int j0 = org + i;
    // the in-band slots are the rows 1..tl of the band: lo..hi; the last
    // in-band row has no left predecessor when the band holds more than
    // one row, nor has slot bw - 1
    const int lo = max(1 - j0, 0);
    const int hi = min(tl - j0, bw - 1);
    const int stop = hi > lo || hi == bw - 1 ? hi : -1;
    int v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // selects, not branches: every value is computed
      const int k = k0 + s;
      const int diag = P[s] + (tc[s] == qc ? match : mismatch);
      const int left = (s + 1 < S ? P[s + 1] : next0) + gap2;
      const int up = max(diag, k == stop ? kInvalid : left);
      v[s] = k < lo ? kInvalid : up;
      if (s > 0) v[s] = max(v[s], v[s - 1]);
    }
    // the next lane's slot 0 before its fix-up, fetched beside the scan
    const int vd = __shfl_down_sync(kFull, v[0], 1);
    // the max over the slots of the lanes before this one
    const int before = warp_max_before(v[S - 1], lane);
    int* row = out + (size_t)i * bw;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s;
      P[s] = k >= lo && k <= hi ? max(v[s], before) : -kg[s];
      if (k < bw) row[k] = P[s] + kg[s];
    }
    // slot k0 + S (the next lane's slot 0) after its fix-up: its lanes
    // before are this one and those below it
    next0 = k1 >= lo && k1 <= hi ? max(vd, max(before, v[S - 1])) : -kg1;
    // the next column's bytes: one slot down
    const int from_next = __shfl_down_sync(kFull, tc[0], 1);
#pragma unroll
    for (int s = 0; s + 1 < S; ++s) tc[s] = tc[s + 1];
    tc[S - 1] = lane == 31 ? t31 : from_next;
    t31 = t31_next;
    qc = qc_next;
  }
}

template <int S>
int launch_fill(const int8_t* q, const int8_t* t, const int* t_len, const int* origin,
                int N, int Q, int T, int bw, int match, int gap, int mismatch, int* cells,
                cudaStream_t st) {
  banded_fill_kernel<S><<<(N + kFillWarps - 1) / kFillWarps, kFillWarps * 32, 0, st>>>(
      q, t, t_len, origin, N, Q, T, bw, match, gap, mismatch, cells);
  return (int)cudaGetLastError();
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

// bw <= 1024: S = ceil(bw / 32) slots a thread, rounded up to an
// instantiated count
extern "C" int lrsc_banded_fill(const int8_t* q, const int8_t* t, const int* t_len,
                                const int* origin, int N, int Q, int T, int bw,
                                int match, int gap, int mismatch, int* cells,
                                void* stream) {
  if (bw < 1 || bw > 1024 || T < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaGetLastError();
  const int need = (bw + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
#define LRSC_FILL(S) \
  if (need <= S)     \
  return launch_fill<S>(q, t, t_len, origin, N, Q, T, bw, match, gap, mismatch, cells, st)
  LRSC_FILL(1);
  LRSC_FILL(2);
  LRSC_FILL(3);
  LRSC_FILL(4);
  LRSC_FILL(5);
  LRSC_FILL(6);
  LRSC_FILL(7);
  LRSC_FILL(8);
  LRSC_FILL(12);
  LRSC_FILL(16);
  LRSC_FILL(24);
  LRSC_FILL(32);
#undef LRSC_FILL
  return (int)cudaErrorInvalidValue;
}
