#!/usr/bin/env python3
"""banded_fill and wcache_level_up on one CUDA card, variant by variant.

    python3 tools/prof_fill_levelup.py [--tree NAME=DIR ...] [--variants a,b,...]
                                       [--sass DIR]

Builds msa.cu and walk.cu as they are ("shipped"), text-edited copies of
them (the variants below, under build/prof_fill_levelup/) and, with
--tree, the sources of other checkouts (DIR/longreadselfcorrect_tpu_torch/
csrc, as NAME), one nvcc each, all at once, and prints each build's ptxas
line for the two kernels (--sass DIR also writes their SASS into DIR).
Then, on chip_smoke.py's bench data (its phase 3: the 4 Mb / 30x index):

* wcache_level_up on every level-up of get_tables (parents of level 8, 9,
  10 and 11, from the host trie and then from the plain version): each
  variant held against wcache_level_up_plain, its event ms (median of 5)
  and device ms (chip_smoke.device_ms: events queued behind a sleep
  kernel, median of 7), the index rows the level reads (rank.RowTracker)
  and the byte bound (rows once, parents read, children written).
* banded_fill on every call the DP path makes in pbcorrect's stream over
  the 256 reads at 8% error and the 256 at 15% (recorded from
  msa_kernels.banded_fill): each variant held against banded_fill_plain,
  its device ms and microseconds per column; the pass's sum; on the
  median 15% call the whole banded_fill call (encode, upload, kernel,
  download into pinned memory) and the download alone.

One JSON line per measurement, the card's name and power limit first.
Exits 1 if a variant that is meant to be exact differs from the plain
version (levelup-loads-only, a measuring aid, is not).
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_variants import REPO, build, cs, device_ms, say, variant  # noqa: E402

OUT = os.path.join(REPO, "build", "prof_fill_levelup")
SOURCES = ("msa.cu", "walk.cu", "walk.cuh", "rank.cuh", "ladder.cuh")
ENTRIES = ("lrsc_banded_fill", "lrsc_wcache_level_up")
# the sources a variant family changes (the others build both)
SOURCES_OF = {"fill": ("msa.cu",), "levelup": ("walk.cu",)}

# name -> text edits ((file, old, new), each old present) of the shipped
# sources; every variant but those in INEXACT computes the same cells and
# intervals
FILL_STORE = """    int* row = out + (size_t)i * bw;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s;
      P[s] = k >= lo && k <= hi ? max(v[s], before) : -kg[s];
      if (k < bw) row[k] = P[s] + kg[s];
    }
"""
FILL_TILE = """    int* row = out + (size_t)i * bw;
    __syncwarp();  // the last column's tile has been read
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s;
      P[s] = k >= lo && k <= hi ? max(v[s], before) : -kg[s];
      tile[k] = P[s] + kg[s];
    }
    __syncwarp();
    for (int k = lane; k < bw; k += 32) row[k] = tile[k];
"""
FILL_WINDOW = """    const int from_next = __shfl_down_sync(kFull, tc[0], 1);
#pragma unroll
    for (int s = 0; s + 1 < S; ++s) tc[s] = tc[s + 1];
    tc[S - 1] = lane == 31 ? t31 : from_next;
"""
FILL_LOAD = """#pragma unroll
    for (int s = 0; s < S; ++s) tc[s] = tn[min(max(org + i + k0 + s, 0), T - 1)];
"""
FILL_LAUNCH = "kFillWarps * 32, 0, st>>>("
FILL_HEAD = "  const int8_t* qn = q + (size_t)n * Q;\n"
FILL_T = "  const int8_t* tn = t + (size_t)n * T;\n"
FILL_LOOP_START = "  const int k0 = lane * S, gap2 = 2 * gap;\n"
FILL_LOOP_END = "    qc = qc_next;\n  }\n"
# strided slot ownership: slot k = 32 s + lane, so a column's stores are
# coalesced as they are; left is the next lane's slot (lane 31: lane 0's
# next slot) and the up-chain a warp scan per slot row with a carry
FILL_STRIDED = """  int prev[S];
#pragma unroll
  for (int s = 0; s < S; ++s) prev[s] = 0;
  for (int k = lane; k < bw; k += 32) out[k] = 0;
  for (int i = 1; i <= Q; ++i) {
    const int qc = qn[i - 1];
    const int j0 = org + i;
    const int lo = max(1 - j0, 0);
    const int hi = min(tl - j0, bw - 1);
    const bool cut = hi > lo;
    int carry = kInvalid, cur[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = 32 * s + lane;
      const int tc = tn[min(max(j0 + k - 1, 0), T - 1)];
      const int dn = __shfl_down_sync(kFull, prev[s], 1);
      const int wrap = __shfl_sync(kFull, s + 1 < S ? prev[s + 1] : 0, 0);
      const int diag = prev[s] + (tc == qc ? match : mismatch);
      const int left = (lane == 31 ? wrap : dn) + gap;
      const int base = k + 1 < bw && !(cut && k == hi) ? max(diag, left) : diag;
      int v = k >= lo && k <= hi ? base - k * gap : kInvalid;
      v = max(max(warp_max_before(v, lane), v), carry);
      carry = __shfl_sync(kFull, v, 31);
      cur[s] = k >= lo && k <= hi ? v + k * gap : 0;
    }
    int* row = out + (size_t)i * bw;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      prev[s] = cur[s];
      if (32 * s + lane < bw) row[32 * s + lane] = cur[s];
    }
  }
"""
LEVEL_COUNT_START = "  unsigned sa[4] = {0u, 0u, 0u, 0u}, sb[4] = {0u, 0u, 0u, 0u}, f[4], g[4];\n"
LEVEL_COUNT_END = "  for (int c = 0; c < 4; ++c) {\n    const int na"
LEVEL_ORDER = "  if (k <= kLevelRun) return g;\n"
LEVEL_RUN = "constexpr int kLevelRun = 2;"
INEXACT = {"levelup-loads-only"}


def cut(csrc, f, start, end, new):
    """The edit replacing csrc/f from `start` through `end` with new."""
    with open(os.path.join(csrc, f)) as fh:
        text = fh.read()
    a = text.index(start)
    return [(f, text[a : text.index(end, a) + len(end)], new)]


def variants(csrc):
    """name -> edits of the sources in csrc."""
    return {
        "shipped": [],
        # banded_fill: the column stored through a per-warp tile in shared
        # memory, every 32-byte sector of the row written once
        "fill-tile": [("msa.cu", FILL_HEAD, "  extern __shared__ int fill_smem[];\n"
                       "  int* tile = fill_smem + w * 32 * S;\n" + FILL_HEAD),
                      ("msa.cu", FILL_STORE, FILL_TILE),
                      ("msa.cu", FILL_LAUNCH,
                       "kFillWarps * 32, sizeof(int) * kFillWarps * 32 * S, st>>>(")],
        # banded_fill: each column's target bytes loaded anew (clamped),
        # from device memory or from a copy of the row in shared memory
        "fill-ldg": [("msa.cu", FILL_WINDOW, FILL_LOAD)],
        "fill-smem": [("msa.cu", FILL_WINDOW, FILL_LOAD),
                      ("msa.cu", FILL_T, "  extern __shared__ int8_t fill_rows[];\n"
                       "  int8_t* tn = fill_rows + (size_t)w * T;\n"
                       "  for (int x = lane; x < T; x += 32) tn[x] = t[(size_t)n * T + x];\n"
                       "  __syncwarp();\n"),
                      ("msa.cu", FILL_LAUNCH, "kFillWarps * 32, kFillWarps * (size_t)T, st>>>(")],
        "fill-strided": cut(csrc, "msa.cu", FILL_LOOP_START, FILL_LOOP_END, FILL_STRIDED),
        # wcache_level_up: parents in code order (thread g takes parent g)
        "levelup-code-order": [("walk.cu", LEVEL_ORDER, "  if (k > 0) return g;\n" + LEVEL_ORDER)],
        # wcache_level_up: one sweep in digit-reversed order (f_lo rises over
        # the whole level; a thread's 16-byte reads and writes far from its
        # neighbours')
        "levelup-one-sweep": [("walk.cu", LEVEL_ORDER,
                               "  if (k > 0) {\n    int r = 0;\n    for (int d = 0; d < k; ++d) "
                               "{\n      r = (r << 2) | (g & 3);\n      g >>= 2;\n    }\n"
                               "    return r;\n  }\n" + LEVEL_ORDER)],
        # wcache_level_up: runs of 4 or 64 consecutive codes (4 or 64 streams)
        "levelup-run1": [("walk.cu", LEVEL_RUN, "constexpr int kLevelRun = 1;")],
        "levelup-run3": [("walk.cu", LEVEL_RUN, "constexpr int kLevelRun = 3;")],
        # wcache_level_up with the counting replaced by an xor of the loaded
        # words (not exact): the loads and writes alone
        "levelup-loads-only": cut(csrc, "rank.cuh", LEVEL_COUNT_START, LEVEL_COUNT_END,
                                  LEVEL_COUNT_START + """#pragma unroll
  for (int v = 0; v < 4; ++v) {
    sa[v] ^= xa[v].x ^ xa[v].y ^ xa[v].z ^ xa[v].w ^ ra2 ^ fa;
    sb[v] ^= xb[v].x ^ xb[v].y ^ xb[v].z ^ xb[v].w ^ rb2 ^ fb;
  }
  f[0] = g[0] = 0u;
#pragma unroll
""" + LEVEL_COUNT_END),
    }


def main() -> int:
    import numpy as np
    import torch

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
    from longreadselfcorrect_tpu_torch.ops import cuda, msa_kernels, rank, walk

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: the sources of another checkout at DIR, built as NAME")
    ap.add_argument("--variants", default="shipped,fill-tile,fill-ldg,fill-smem,fill-strided,"
                    "levelup-code-order,levelup-one-sweep,levelup-run1,levelup-run3,"
                    "levelup-loads-only")
    ap.add_argument("--sass", metavar="DIR",
                    help="write cuobjdump -sass of the shipped builds into DIR")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    cs.phase_device()
    names = [v for v in a.variants.split(",") if v]
    edits = variants(cuda.CSRC)
    specs = [(n, variant(OUT, n, SOURCES, edits[n]), src)
             for n in names for src in SOURCES_OF.get(n.split("-")[0], ("msa.cu", "walk.cu"))]
    for tree in a.tree:
        name, root = tree.split("=", 1)
        tdir = os.path.join(root, "longreadselfcorrect_tpu_torch", "csrc")
        specs += [(name, variant(OUT, name, SOURCES, [], tdir), src)
                  for src in ("msa.cu", "walk.cu")]
        names = [name] + names
    t0 = time.perf_counter()
    libs = build(specs, ("banded_fill", "wcache_level_up"), ENTRIES)
    say(built_s=round(time.perf_counter() - t0, 1))
    if a.sass:
        os.makedirs(a.sass, exist_ok=True)
        tool = os.path.join(os.path.dirname(cuda.nvcc_path()), "cuobjdump")
        for src in ("msa.cu", "walk.cu"):
            so = os.path.join(OUT, "shipped", src.replace(".cu", ".so"))
            with open(os.path.join(a.sass, f"sass_{src[:-3]}.txt"), "w") as fh:
                subprocess.run([tool, "-sass", so], stdout=fh, stderr=subprocess.STDOUT)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    hix, dix, items, _, dp = cs.phase_data()[:5]
    bad = []

    # every level-up of get_tables, parents of level 8..11
    lv = walk.build_kmer_levels(hix, walk.CACHE_K)[-1]
    st = tuple(torch.from_numpy(np.ascontiguousarray(lv[:, i])).cuda() for i in range(4))
    ck = walk.walk_ck(hix.bwt.n)
    for k in range(walk.CACHE_K, ck):
        n = st[0].numel()
        with rank.RowTracker(dix) as rt:
            want, plain_ms = cs.time_once(lambda: walk.wcache_level_up_plain(dix, *st))
        b_ms, b_by = cs.bound(16 * n + 64 * n + rt.rows * 132, 0)
        res = {}
        for name in [x for x in names if (x, "walk.cu") in libs]:
            fn = libs[(name, "walk.cu")].lrsc_wcache_level_up
            outs = [torch.full((4 * n,), -7, dtype=torch.int32, device="cuda") for _ in range(4)]
            p = cuda.ptr_array(walk._index_ptrs("wcache_level_up", dix)
                               + [t.data_ptr() for t in st] + [o.data_ptr() for o in outs])
            d = cuda.int_array(walk._index_dims(dix) + [n, k])

            def call():
                assert fn(p, d, stream()) == 0
            call()
            torch.cuda.synchronize()
            exact = all(bool(torch.equal(g, w)) for g, w in zip(outs, want))
            if not exact and name not in INEXACT:
                bad.append(f"wcache_level_up {name} level {k}")
            res[name] = dict(exact=exact, ms=round(cs.time_ms(call), 4),
                             device_ms=device_ms(call))
        say(kernel="wcache_level_up", level=f"{k}->{k + 1}", parents=n, rows=rt.rows,
            bound_ms=round(b_ms, 5), bound_by=b_by, plain_ms=round(plain_ms, 3), **res)
        st = want

    # every banded_fill call of the DP path, 8% and 15%
    params = CorrectionParams(pb_coverage=cs.COVERAGE, genome=10)
    corr = BatchedSelfCorrector(hix, dix, params)
    for label, reads in (("8%", items), ("15%", dp)):
        calls = []
        with cs.recording(msa_kernels, "banded_fill", calls):
            cs.run_stream(BatchedSelfCorrector(hix, corr.wx, params), reads)
        fill_names = [x for x in names if (x, "msa.cu") in libs]
        sums = {name: 0.0 for name in fill_names}
        per_call = []
        for qs, ts, s1, s2, band, scores, _ in calls:
            q, t, tl, org, bw = msa_kernels.encode_pairs(qs, ts, s1, s2, band)
            dev = [torch.from_numpy(x).cuda() for x in (q, t, tl, org)]
            N, Q = q.shape
            want = msa_kernels.banded_fill_plain(*dev, bw, scores)
            row = dict(N=N, Q=Q, T=t.shape[1], bw=bw)
            for name in fill_names:
                fn = libs[(name, "msa.cu")].lrsc_banded_fill
                cells = torch.full((N, Q + 1, bw), -7, dtype=torch.int32, device="cuda")

                def call():
                    assert fn(*[x.data_ptr() for x in dev], N, Q, t.shape[1], bw,
                              *scores, cells.data_ptr(), stream()) == 0
                call()
                torch.cuda.synchronize()
                exact = bool(torch.equal(cells, want))
                if not exact and name not in INEXACT:
                    bad.append(f"banded_fill {name} {label} N={N} Q={Q}")
                ms = device_ms(call)
                sums[name] += ms
                row[name] = dict(exact=exact, device_ms=ms, us_per_column=round(ms * 1e3 / Q, 3))
            per_call.append(row)
        say(kernel="banded_fill", pass_=label, calls=len(calls), per_call=per_call,
            pass_device_ms={k: round(v, 4) for k, v in sums.items()})
        if label == "15%" and calls:
            qs, ts, s1, s2, band, scores, device = sorted(
                calls, key=lambda c: len(c[0]) * max(map(len, c[0])))[len(calls) // 2]
            q, t, tl, org, bw = msa_kernels.encode_pairs(qs, ts, s1, s2, band)
            dev = [torch.from_numpy(x).cuda() for x in (q, t, tl, org)]
            cells = msa_kernels.banded_fill_tensors(*dev, bw, scores)
            host = torch.empty(cells.shape, dtype=cells.dtype, pin_memory=True)
            say(kernel="banded_fill", median_call=f"N={q.shape[0]} Q={q.shape[1]} bw={bw}",
                cells_mb=round(cells.numel() * 4 / 1e6, 3),
                whole_call_wall_ms=round(cs.wall_ms(lambda: msa_kernels.banded_fill(
                    qs, ts, s1, s2, band, scores, device), reps=7), 4),
                download_ms=round(cs.time_ms(lambda: host.copy_(cells), reps=7), 4),
                shipped_kernel_device_ms=device_ms(
                    lambda: msa_kernels.banded_fill_tensors(*dev, bw, scores)))
    say(exact=not bad, mismatches=bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
