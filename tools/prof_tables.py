#!/usr/bin/env python3
"""Where the k-mer tables' and walk_prep's time goes, on one CUDA card.

    python3 tools/prof_tables.py [--parts full,prep,freq,wire,planes] [--tree NAME=DIR ...]

Builds variants of csrc/kmer_table.cu and csrc/walk.cu (text edits of the
sources, under build/prof_tables/) and times them on chip_smoke.py's bench
data (its phase 3): kmer_table_full on the 8% set's first 64-read chunk,
walk_prep on the 7312-task bank of the 256 noisy reads and on a 64-row
batch launch.  Device time of the kernel (chip_smoke.device_ms: events
queued behind a sleep kernel, median of 7 after a warm-up), so no host
time is in it.  Variants:

* shipped    the sources as they are;
* occ        update_interval_shared made update_interval (each end of an
             interval reads its own index row, vector by vector);
* bounded    __launch_bounds__ asking for 4 blocks of 256 threads
             (kmer_table_full) or 8 of 128 (walk_prep) an SM;
* no-step    walk_prep with every ladder cut to its table level (no LF
             step: not exact, it shows what the steps cost);
* freq-*     kmer_freq_scan's variants (freq_variants() below).

Also kmer_table_full with max_k cut to 13, 19, 30 and 40, with and
without the pyramid (the levels' share of the time), kmer_table_planes on
the same chunk, and walk_prep's parts (the code rows, the terminal
windows, the chain ring with the root) alone.

Part `freq`: kmer_freq_scan on the same chunk at pbcorrect's pool and at
the single scan k, with the walk index's pyramid and without it where the
build's C entry takes one, held against kmer_freq_scan_plain, with its
rank queries from level 1 and from each lane's pyramid level: the
shipped kmer_table.cu and, with --tree NAME=DIR, the kmer_table.cu of
another checkout (`--tree parent=build/parent` after `git archive
<commit> | tar -x -C build/parent`).

Parts `wire` and `planes`: kmer_table_wire (from the pyramid and from
level 1) and kmer_table_planes on the same chunk, held against their plain
versions, for the shipped sources, the wire kernel's lane-list variants
(list_variants() below), the plane kernel's other designs
(plane_variants(): its table on the lane list, a step reading one row for
both ends) and each --tree checkout (an entry without the pyramid's
arguments is called as such); kmer_table_full from the pyramid beside
them (shipped, with the lane list's step, each checkout's); the shipped
kernels with max_k cut from 12 to 51; then, level by level past the
start, the lanes that
step (live: started, inside the read, a strand non-empty), the warps a
thread-per-lane kernel issues a round of loads for (any of its 32
consecutive lanes live) and the warps of the compacted lists (live lanes
of each block of SPAN, in warps of 32): what the divergence costs.

One JSON line per measurement, the card's name and power limit first;
every build's ptxas line (registers, stack frame, spill stores and loads).
"""
import argparse
import ctypes
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_variants import REPO, build, cs, device_ms, say, variant  # noqa: E402

OUT = os.path.join(REPO, "build", "prof_tables")
SOURCES = ("kmer_table.cu", "walk.cu", "walk.cuh", "rank.cuh", "ladder.cuh", "lane_list.cuh",
           "planes.cu", "planes.cuh")
SPAN = 256    # lanes a block of the lane-list kernels (lane_list.cuh kListLanes)
# lrsc_kmer_table_wire before it took the pyramid
WIRE_FROM_LEVEL_1 = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
                     + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def freq_variants():
    """name -> text edits of kmer_table.cu for kmer_freq_scan (part freq),
    each exact."""
    return {
        # kmer_table_full's step past the pyramid (both strands in one round
        # of loads, one row for both ends of an interval in one block)
        # instead of ladder.cuh's
        "freq-shared": [("kmer_table.cu", """    lrsc::ladder(fwd, rev, row, p, L, len, max(c, 1), pool.k[top - 1], st,
                 [&](int j, bool, const lrsc::BiInterval& s) {
                   if (j == pool.k[i]) freq[i++ * plane + lane] = s.size();
                 });""", """    lrsc::BiInterval s = st;
    for (int j = max(c, 1);; ++j) {
      if (j == pool.k[i]) {
        freq[i++ * plane + lane] = s.size();
        if (i == top) break;
      }
      step_level(fwd, rev, row, p, L, j, s);
    }""")],
    }


# lane_list.cuh's step with ladder.cuh's rule, strand by strand, each end
# of an interval from its own row (Rank::update)
LIST_LADDER = [("lane_list.cuh", """  fwd.update_shared(s, st.f_lo, st.f_hi, fv);
  rev.update_shared(comp(s), st.r_lo, st.r_hi, rv);""", """  if (fv) fwd.update(s, st.f_lo, st.f_hi);
  if (rv) rev.update(comp(s), st.r_lo, st.r_hi);""")]

# lane_list.cuh's level loop with two list lanes a thread, their loads
# issued together
LIST_ILP2 = [("lane_list.cuh", """    for (int b = 0; b < n; b += kListThreads) {
      if (b + (t & ~31) >= n) break;  // the warp's lanes all past the list
      const bool on = b + t < n;
      const int id = on ? (int)sh.ids[cur][b + t] : 0;
      BiInterval st = on ? as_bi(sh.st[id]) : BiInterval{1, 0, 1, 0};
      // a listed lane has j < len - p: its symbol lies inside its read
      const int sym = !on                 ? kPadRank
                      : id + j < kSymSpan ? (int)sh.sym[id + j]
                                          : (int)__ldg(reads + base + id + j);
      list_step(fwd, rev, sym, st);
      const bool fv = st.f_lo <= st.f_hi, rv = st.r_lo <= st.r_hi;
      const bool keep = on && (fv || rv) && j + 1 < max_k && j + 1 < sh.lim[id];
      if (on) {
        sh.stage_f[id] = st.size();
        sh.stage_v[id] = (uint8_t)(1 | ((fv && rv) ? 2 : 0));
        if (keep) sh.st[id] = as_int4(st);
      }
      append(sh, nxt_list, keep, id);
    }""", """    constexpr int kIlp = 2;
    for (int b = 0; b < n; b += kIlp * kListThreads) {
      if (b + (t & ~31) >= n) break;  // the warp's lanes all past the list
      int id[kIlp], sym[kIlp];
      bool on[kIlp];
      BiInterval st[kIlp];
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        const int e = b + k * kListThreads + t;
        on[k] = e < n;
        id[k] = on[k] ? (int)sh.ids[cur][e] : 0;
        st[k] = on[k] ? as_bi(sh.st[id[k]]) : BiInterval{1, 0, 1, 0};
        sym[k] = !on[k]                 ? kPadRank
                 : id[k] + j < kSymSpan ? (int)sh.sym[id[k] + j]
                                        : (int)__ldg(reads + base + id[k] + j);
      }
#pragma unroll
      for (int k = 0; k < kIlp; ++k) list_step(fwd, rev, sym[k], st[k]);
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        const bool fv = st[k].f_lo <= st[k].f_hi, rv = st[k].r_lo <= st[k].r_hi;
        const bool keep = on[k] && (fv || rv) && j + 1 < max_k && j + 1 < sh.lim[id[k]];
        if (on[k]) {
          sh.stage_f[id[k]] = st[k].size();
          sh.stage_v[id[k]] = (uint8_t)(1 | ((fv && rv) ? 2 : 0));
          if (keep) sh.st[id[k]] = as_int4(st[k]);
        }
        append(sh, nxt_list, keep, id[k]);
      }
    }""")]

# the wire kernel's start with the clean-prefix rule and the pyramid's code
# shifts written out, not through clean_prefix / pyramid_level: the
# prefix's staged symbols all read before any test (no loop exit)
WIRE_INLINE_START = [("kmer_table.cu", """    unsigned code;
    const int c = clean_prefix(sh.sym + id, min(cmax, L - p), code);
    lrsc::BiInterval e[kMaxPyramid];
#pragma unroll
    for (int x = 0; x < kMaxPyramid; ++x)
      if (x < c) e[x] = pyramid_level(pyr, x + 1, code, c);""", """    unsigned code = 0;
    int c = 0;
#pragma unroll
    for (int x = 0; x < kMaxPyramid; ++x) {
      const int s = x < cmax && p + x < L ? (int)sh.sym[id + x] : 0;
      if (c == x && s >= 1 && s <= 4) {
        code = (code << 2) | (unsigned)(s - 1);
        ++c;
      }
    }
    lrsc::BiInterval e[kMaxPyramid];
#pragma unroll
    for (int x = 0; x < kMaxPyramid; ++x)
      if (x < c) {
        const int4 v = __ldg(level_row(pyr, x + 1, code >> (2 * (c - 1 - x))));
        e[x] = lrsc::BiInterval{v.x, v.y, v.z, v.w};
      }""")]


def list_variants():
    """name -> text edits of the wire kernel on lane_list.cuh (part wire),
    each exact."""
    def span(lanes, threads):
        return [("lane_list.cuh", "constexpr int kListLanes = 256;",
                 f"constexpr int kListLanes = {lanes};"),
                ("lane_list.cuh", "constexpr int kListThreads = 128;",
                 f"constexpr int kListThreads = {threads};")]
    return {
        # ladder.cuh's step, strand by strand, on the list
        "list-ladder": LIST_LADDER,
        # two list lanes a thread at once
        "list-ilp2": LIST_ILP2,
        # the start without the shared helpers
        "wire-inline-start": WIRE_INLINE_START,
        # blocks of 1024 lanes (256 threads owning 4 each), of 512 (256
        # threads owning 2) and of 256 (256 threads owning 1)
        "list-1024-own4": span(1024, 256),
        "list-512-own2": span(512, 256),
        "list-256-own1": span(256, 256),
    }


# kmer_table_full (thread per lane, from the pyramid) with the lane lists'
# step (BlockRank::update_shared: update_interval_shared's rule, no stack)
FULL_REGSTEP = [("kmer_table.cu",
                 """    lrsc::update_interval_shared(fwd.blocks, fwd.ckpt, fwd.C, fwd.nb, s, st.f_lo, st.f_hi, fv);
    lrsc::update_interval_shared(rev.blocks, rev.ckpt, rev.C, rev.nb, lrsc::comp(s), st.r_lo,
                                 st.r_hi, rv);""",
                 """    fwd.update_shared(s, st.f_lo, st.f_hi, fv);
    rev.update_shared(lrsc::comp(s), st.r_lo, st.r_hi, rv);""")]


def full_beside(libs, names, dix, wx, reads, lens, max_k, stream):
    """kmer_table_full from the pyramid of the builds `names` (the shipped
    one, the one with the lane lists' step, other checkouts'), beside the
    wire kernel: one thread a lane against the lists."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import scan

    R, L = reads.shape
    want = scan.kmer_table_full_plain(dix, reads, lens, max_k)
    for name in names:
        fn = libs[(name, "kmer_table.cu")].lrsc_kmer_table_full
        f = torch.full((max_k + 1, R, L), 7, dtype=torch.int32, device="cuda")
        v = torch.ones((max_k + 1, R, L), dtype=torch.bool, device="cuda")
        args = scan.kmer_table_full_args(dix, reads, lens, max_k, wx, f, v)

        def call():
            assert fn(*args, stream()) == 0
        call()
        torch.cuda.synchronize()
        say(kernel="kmer_table_full", build=name, pyramid=True,
            exact=bool(torch.equal(f, want[0]) and torch.equal(v, want[1])),
            device_ms=device_ms(call))


# PlaneRank::update with one row for both ends where they share a block
# (rank.cuh update_interval_shared's rule), every load issued first
PLANE_UPDATE_SHARED = """
  __device__ __forceinline__ void update_shared(int sym, int& lo, int& hi, bool live) const {
    const int pa = lo, pb = hi + 1;
    const int qa = pa >> 7, qb = pb >> 7;
    const int ra = pa - (qa << 7), rb = pb - (qb << 7);
    const bool same = qa == qb;
    const int* rowa = prows + (size_t)min(max(qa, 0), nb - 1) * kPlaneRow;
    const int* rowb = prows + (size_t)min(max(qb, 0), nb - 1) * kPlaneRow;
    const int needa = !live ? 0 : same ? max(ra, rb) : ra;
    const int needb = !live || same ? 0 : rb;
    const int pc = live ? __ldg(C + sym) : 0;
    const int cka = live ? __ldg(rowa + 3 * kPlaneWords + sym) : 0;
    const int ckb = live && !same ? __ldg(rowb + 3 * kPlaneWords + sym) : cka;
    unsigned wa[3][kPlaneWords], wb[3][kPlaneWords];
#pragma unroll
    for (int w = 0; w < kPlaneWords; ++w) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wa[i][w] = needa > 32 * w ? (unsigned)__ldg(rowa + i * kPlaneWords + w) : 0u;
        wb[i][w] = needb > 32 * w ? (unsigned)__ldg(rowb + i * kPlaneWords + w) : 0u;
      }
    }
    const unsigned e0 = 0u - (unsigned)(sym & 1);
    const unsigned e1 = 0u - (unsigned)((sym >> 1) & 1);
    const unsigned e2 = 0u - (unsigned)((sym >> 2) & 1);
    int ca = 0, cb = 0;
#pragma unroll
    for (int w = 0; w < kPlaneWords; ++w) {
      const int ka = ra - 32 * w, kb = rb - 32 * w;
      const unsigned maska = ka <= 0 ? 0u : ka >= 32 ? ~0u : (1u << ka) - 1u;
      const unsigned maskb = kb <= 0 ? 0u : kb >= 32 ? ~0u : (1u << kb) - 1u;
      const unsigned ma = ~((wa[0][w] ^ e0) | (wa[1][w] ^ e1) | (wa[2][w] ^ e2));
      const unsigned mb = same ? ma : ~((wb[0][w] ^ e0) | (wb[1][w] ^ e1) | (wb[2][w] ^ e2));
      ca += __popc(ma & maska);
      cb += __popc(mb & maskb);
    }
    if (live) {
      lo = pc + cka + ca;
      hi = pc + ckb + cb - 1;
    }
  }
};"""

# the plane kernel on lane_list.cuh: each owned lane's rows below ck and
# row ck from the wcache (the owners' four entries in flight together),
# then the compacted ladder, with PlaneRank::update_shared or ::update
PLANES_LIST_KERNEL = """struct PlaneOut {
  int* __restrict__ freq;
  bool* __restrict__ valid;
  size_t plane;

  __device__ __forceinline__ void row(int, size_t lane, int j, int f, bool v) {
    freq[j * plane + lane] = f;
    valid[j * plane + lane] = v;
  }
};

__global__ void __launch_bounds__(lrsc::kListThreads)
    kmer_table_planes_kernel(lrsc::PlaneRank fwd, lrsc::PlaneRank rev,
                             const int4* __restrict__ wcache, int ck,
                             const int8_t* __restrict__ reads, const int* __restrict__ lens,
                             int R, int L, int max_k, int* __restrict__ freq,
                             bool* __restrict__ valid) {
  __shared__ lrsc::LaneList sh;
  const size_t lanes = (size_t)R * L, base = (size_t)blockIdx.x * lrsc::kListLanes;
  PlaneOut out{freq, valid, lanes};
  lrsc::Owned own;
  lrsc::list_begin(sh, max_k, reads, base, lanes);
  __syncthreads();
  const unsigned mask = (1u << (2 * ck)) - 1u;
  int4 w[lrsc::kOwned];
  int lim[lrsc::kOwned];
#pragma unroll
  for (int i = 0; i < lrsc::kOwned; ++i) {
    const int id = lrsc::kListThreads * i + (int)threadIdx.x;
    const size_t lane = base + id;
    if (lane >= lanes) continue;
    const int r = (int)(lane / L), p = (int)(lane - (size_t)r * L);
    unsigned code = 0;
    for (int j = 0; j < ck; ++j) {
      const int c = p + j < L ? (int)sh.sym[id + j] : 1;
      code = ((code << 2) | (unsigned)(min(max(c, 1), 4) - 1)) & mask;
    }
    w[i] = __ldg(wcache + code);
    lim[i] = __ldg(lens + r) - p;
  }
#pragma unroll
  for (int i = 0; i < lrsc::kOwned; ++i) {
    const int id = lrsc::kListThreads * i + (int)threadIdx.x;
    const size_t lane = base + id;
    own.s[i] = 0;
    if (lane >= lanes) continue;
    const lrsc::BiInterval st = lrsc::as_bi(w[i]);
    for (int j = 0; j < ck; ++j) out.row(i, lane, j, -1, false);
    out.row(i, lane, ck, ck > lim[i] ? -1 : st.size(), ck <= lim[i] && st.valid());
    lrsc::list_start(sh, own, out, i, id, lane, ck, lim[i], st, max_k);
  }
  __syncthreads();
  lrsc::list_run(fwd, rev, reads, base, max_k, sh, own, out);
}

"""
PLANE_END = """    lo = nlo;
    hi = nhi;
  }
};"""


def plane_variants():
    """name -> text edits of planes.cu / planes.cuh / ladder.cuh (part
    planes), each exact: the thread-per-lane kernel stepping both strands
    in one round (PlaneRank::update_shared), and the kernel on lane_list.cuh
    with that step or with PlaneRank::update (designs measured against the
    shipped one and not taken)."""
    from longreadselfcorrect_tpu_torch.ops import cuda

    with open(os.path.join(cuda.CSRC, "planes.cu")) as fh:
        text = fh.read()
    kernel = text[text.index("__global__ void kmer_table_planes_kernel("):
                  text.index("}  // namespace")]
    grid = text[text.index("  const size_t lanes = (size_t)R * L;\n  const unsigned grid"):
                text.index("        lrsc::PlaneRank{f_prows")]
    shared = [("planes.cuh", PLANE_END, PLANE_END[:-3] + PLANE_UPDATE_SHARED)]
    lists = shared + [
        ("planes.cu", '#include "ladder.cuh"', '#include "lane_list.cuh"'),
        ("planes.cu", kernel, PLANES_LIST_KERNEL),
        ("planes.cu", grid, "  const size_t blocks = ((size_t)R * L + lrsc::kListLanes - 1) / "
         "lrsc::kListLanes;\n  if (blocks > 0) {\n    kmer_table_planes_kernel<<<(unsigned)blocks, "
         "lrsc::kListThreads, 0, (cudaStream_t)stream>>>(\n")]
    return {
        "planes-shared": shared + [
            ("ladder.cuh", """    if (st.f_lo <= st.f_hi) fwd.update(s, st.f_lo, st.f_hi);
    if (st.r_lo <= st.r_hi) rev.update(comp(s), st.r_lo, st.r_hi);""",
             """    fwd.update_shared(s, st.f_lo, st.f_hi, st.f_lo <= st.f_hi);
    rev.update_shared(comp(s), st.r_lo, st.r_hi, st.r_lo <= st.r_hi);""")],
        "planes-list": lists,
        "planes-list-ladder": lists + LIST_LADDER,
    }


def takes_pyramid(directory, entry="lrsc_kmer_freq_scan") -> bool:
    """Whether the kmer_table.cu in directory has an `entry` that takes the
    pyramid's tables (ck before the reads)."""
    with open(os.path.join(directory, "kmer_table.cu")) as fh:
        m = re.search(r'extern "C" int %s\(([^)]*)\)' % entry, fh.read())
    return "pyr_lower" in m.group(1)


def live_lanes(freq, start, lens, max_k):
    """Per level j from the least start to max_k - 1: the lanes that step j
    -> j + 1 (started at or below j, j < len - p, a strand non-empty: freq
    > 0), the warps of 32 consecutive lanes with one of them live, and the
    warps of each block's compacted list.  freq [K, R, L] the table,
    start [R, L] each lane's start level."""
    import torch

    R, L = start.shape
    lim = lens.long()[:, None] - torch.arange(L, device=start.device)[None, :]
    pad = (-R * L) % SPAN
    out = dict(level=[], live_lanes=[], lane_warps=[], list_warps=[])
    for j in range(int(start.min()), max_k):
        live = ((start <= j) & (j < lim) & (freq[j] > 0)).reshape(-1)
        live = torch.cat([live, live.new_zeros(pad)])
        out["level"].append(j)
        out["live_lanes"].append(int(live.sum()))
        out["lane_warps"].append(int(live.reshape(-1, 32).any(1).sum()))
        out["list_warps"].append(int(((live.reshape(-1, SPAN).sum(1) + 31) // 32).sum()))
    return out


def wire_table(libs, dirs, dix, wx, reads, lens, max_k, stream):
    """kmer_table_wire of each build from the pyramid and from level 1,
    exact against its plain version, device ms; the live lanes either way."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import cuda, scan

    R, L = reads.shape
    K = max_k + 1
    want = scan.kmer_table_wire_plain(dix, reads, lens, max_k)
    for name, d in dirs.items():
        fn = libs[(name, "kmer_table.cu")].lrsc_kmer_table_wire
        pyr = takes_pyramid(d, "lrsc_kmer_table_wire")
        fn.argtypes = cuda._SIGNATURES["lrsc_kmer_table_wire"] if pyr else WIRE_FROM_LEVEL_1
        for levels in ((wx, None) if pyr else (None,)):
            f16 = torch.full((K, R, L), 7, dtype=torch.int16, device="cuda")
            vbits = torch.full(((K + 7) // 8, R, L), 7, dtype=torch.uint8, device="cuda")
            args = scan.kmer_table_wire_args(dix, reads, lens, max_k, levels, f16, vbits)
            if not pyr:
                args = args[:8] + args[11:]   # no pyramid arguments

            def call():
                assert fn(*args, stream()) == 0
            call()
            torch.cuda.synchronize()
            say(kernel="kmer_table_wire", build=name, pyramid=levels is not None,
                exact=bool(torch.equal(f16, want[0]) and torch.equal(vbits, want[1])),
                device_ms=device_ms(call))
    full = scan.kmer_table_full_plain(dix, reads, lens, max_k)[0]
    c = cs.pyramid_start(wx, reads, max_k)[0]
    say(kernel="kmer_table_wire", route="pyramid",
        **live_lanes(full, c.clamp(min=1), lens, max_k))
    say(kernel="kmer_table_wire", route="level 1",
        **live_lanes(full, torch.ones_like(c), lens, max_k))


CUTS = (12, 13, 16, 20, 30, 40)


def table_cuts(dix, pix, wx, reads, lens, max_k, parts):
    """The shipped wire (from the pyramid) and plane kernels cut at max_k
    in CUTS: the share of the time the levels past the start take."""
    from longreadselfcorrect_tpu_torch.ops import scan

    for mk in CUTS + (max_k,):
        res = {}
        if "wire" in parts:
            res["wire"] = device_ms(lambda: scan.kmer_table_wire(dix, reads, lens, mk, wx))
        if "planes" in parts:
            res["planes"] = device_ms(lambda: scan.kmer_table_planes(pix, wx.wcache, reads, lens,
                                                                     mk, wx.ck))
        say(kernel="tables cut", build="shipped", max_k=mk, device_ms=res)


def planes_table(libs, dirs, pix, wx, reads, lens, max_k, stream):
    """kmer_table_planes of each build, exact against its plain version,
    device ms; the live lanes past ck."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import scan

    R, L = reads.shape
    K, ck = max_k + 1, wx.ck
    want = scan.kmer_table_planes_plain(pix, wx.wcache, reads, lens, max_k, ck)
    for name in dirs:
        fn = libs[(name, "planes.cu")].lrsc_kmer_table_planes
        freq = torch.full((K, R, L), 7, dtype=torch.int32, device="cuda")
        valid = torch.ones((K, R, L), dtype=torch.bool, device="cuda")
        args = scan.kmer_table_planes_args(pix, wx.wcache, reads, lens, max_k, ck, freq, valid)

        def call():
            assert fn(*args, stream()) == 0
        call()
        torch.cuda.synchronize()
        say(kernel="kmer_table_planes", build=name,
            exact=bool(torch.equal(freq, want[0]) and torch.equal(valid, want[1])),
            device_ms=device_ms(call))
    say(kernel="kmer_table_planes",
        **live_lanes(want[0], torch.full_like(reads, ck, dtype=torch.long), lens, max_k))


def freq_scan(libs, dirs, dix, wx, reads, lens, pools, stream):
    """kmer_freq_scan of each build on one chunk, each pool with and
    without the pyramid where the build takes one: exact against the plain
    version, device ms."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import cuda, scan

    R, L = reads.shape
    for pool in pools:
        want = scan.kmer_freq_scan_plain(dix, reads, lens, pool)
        for name, d in dirs.items():
            fn = libs[(name, "kmer_table.cu")].lrsc_kmer_freq_scan
            pyr = takes_pyramid(d)
            fn.argtypes = cuda._SIGNATURES["lrsc_kmer_freq_scan"] if pyr else (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
            for levels in ((wx, None) if pyr else (None,)):
                out = torch.full((len(pool), R, L), 7, dtype=torch.int32, device="cuda")
                args = (scan._index_args("kmer_freq_scan", dix, reads)
                        + (scan._pyramid_args("kmer_freq_scan", levels, reads) if pyr else [])
                        + scan._read_args("kmer_freq_scan", reads, lens)
                        + [cuda.int_array(pool), len(pool), out.data_ptr()])

                def call():
                    assert fn(*args, stream()) == 0
                call()
                torch.cuda.synchronize()
                say(kernel="kmer_freq_scan", build=name, pool=list(pool),
                    pyramid=levels is not None, exact=bool(torch.equal(out, want)),
                    ms=round(cs.time_ms(call), 4), device_ms=device_ms(call))
        rows1, q1, _ = cs.rank_traffic(dix, reads, pool[-1])
        c, st_c, entries = cs.pyramid_start(wx, reads, pool[-1], pool)
        rows, q, loads = cs.rank_traffic(dix, reads, pool[-1], st_c, c.clamp(min=1))
        say(kernel="kmer_freq_scan", pool=list(pool), from_level_1=dict(rows=rows1, queries=q1),
            from_pyramid=dict(rows=rows, queries=q, row_loads=loads, pyramid_entries=entries))


def main() -> int:
    import torch

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="full,prep,freq",
                    help="full (kmer_table_full), prep (walk_prep), freq (kmer_freq_scan), "
                         "wire (kmer_table_wire), planes (kmer_table_planes)")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: the kmer_table.cu and planes.cu of another checkout at "
                         "DIR, for parts freq, wire and planes")
    a = ap.parse_args()
    parts = set(a.parts.split(","))
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    cs.phase_device()
    # (update_interval_shared's first line: occ_acgt_pair starts alike)
    occ = [("rank.cuh", "bool live = true) {\n  const int pa = lo, pb = hi + 1;",
            "bool live = true) {\n"
            "  if (live) update_interval(blocks, ckpt, C, nb, sym, lo, hi);\n  return;\n"
            "  const int pa = lo, pb = hi + 1;")]
    bounded = [("kmer_table.cu", "__global__ void kmer_table_full_kernel(",
                "__global__ void __launch_bounds__(256, 4) kmer_table_full_kernel("),
               ("walk.cu", "__launch_bounds__(kPrepWarps * 32)\n",
                "__launch_bounds__(kPrepWarps * 32, 8)\n")]
    no_step = [("walk.cuh", "    wcache_get(ix, code, st);\n    from = P.CK;",
                "    wcache_get(ix, code, st);\n    from = P.CK;\n    n = P.CK;")]
    edits = {"shipped": [], "occ": occ, "bounded": bounded, "no-step": no_step}
    specs = [(name, variant(OUT, name, SOURCES, edits[name]), src)
             for src, names in (("kmer_table.cu", ("shipped", "occ", "bounded")
                                 if "full" in parts else ("shipped",)),
                                ("walk.cu", ("shipped", "occ", "bounded", "no-step")
                                 if "prep" in parts else ()))
             for name in names]
    dirs = {"shipped": specs[0][1]}
    if "freq" in parts:
        for name, fe in freq_variants().items():
            dirs[name] = variant(OUT, name, SOURCES, fe)
            specs.append((name, dirs[name], "kmer_table.cu"))
    tables = parts & {"wire", "planes"}
    wire_dirs = {"shipped": dirs["shipped"]} if "wire" in parts else {}
    plane_dirs = {"shipped": dirs["shipped"]} if "planes" in parts else {}
    for name, le in (list_variants() if "wire" in parts else {}).items():
        wire_dirs[name] = variant(OUT, name, SOURCES, le)
        specs.append((name, wire_dirs[name], "kmer_table.cu"))
    if "wire" in parts:
        specs.append(("full-regstep", variant(OUT, "full-regstep", SOURCES, FULL_REGSTEP),
                      "kmer_table.cu"))
    for name, pe in (plane_variants() if "planes" in parts else {}).items():
        plane_dirs[name] = variant(OUT, name, SOURCES, pe)
    for tree in a.tree:
        name, root = tree.split("=", 1)
        dirs[name] = variant(OUT, name, SOURCES, [],
                             os.path.join(root, "longreadselfcorrect_tpu_torch", "csrc"))
        specs.append((name, dirs[name], "kmer_table.cu"))
        if "wire" in parts:
            wire_dirs[name] = dirs[name]
        if "planes" in parts:
            plane_dirs[name] = dirs[name]
    specs += [(name, d, "planes.cu") for name, d in plane_dirs.items()]
    t0 = time.perf_counter()
    libs = build(specs, ("kmer_table_full", "walk_prep", "kmer_freq_scan", "kmer_table_wire",
                         "kmer_table_planes", "plane_rows"),
                 ("lrsc_kmer_table_full", "lrsc_walk_prep", "lrsc_kmer_table_planes"))
    say(built_s=round(time.perf_counter() - t0, 1))
    hix, dix, items = cs.phase_data()[:3]
    corr = BatchedSelfCorrector(hix, dix, CorrectionParams(pb_coverage=cs.COVERAGE, genome=10))
    wx, stream = corr.wx, lambda: torch.cuda.current_stream().cuda_stream
    max_k = corr.probe_params.kmer_len_up_bound + 1
    _, _, mat, lens = next(corr._seed_chunks(items))
    reads, lens = torch.from_numpy(mat).cuda(), torch.from_numpy(lens).cuda()
    if "freq" in parts:
        pp = corr.probe_params
        freq_scan(libs, dirs, dix, wx, reads, lens, (tuple(pp.pool), (pp.scan_kmer_len,)),
                  stream)
    if tables:
        from longreadselfcorrect_tpu_torch.ops import scan

        pix = scan.plane_index_of(hix, wx)
    if "wire" in parts:
        wire_table(libs, wire_dirs, dix, wx, reads, lens, max_k, stream)
        full_beside(libs, ["shipped", "full-regstep"] + [t.split("=", 1)[0] for t in a.tree],
                    dix, wx, reads, lens, max_k, stream)
    if "planes" in parts:
        planes_table(libs, plane_dirs, pix, wx, reads, lens, max_k, stream)
    if tables:
        table_cuts(dix, pix, wx, reads, lens, max_k, parts)
    if "full" in parts:
        full_table(libs, hix, dix, wx, reads, lens, max_k, stream)
    if "prep" in parts:
        prep(libs, corr, wx, items, stream)
    return 0


def full_table(libs, hix, dix, wx, reads, lens, max_k, stream):
    """kmer_table_full's variants on one chunk, its max_k cuts and
    kmer_table_planes beside it."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import scan

    R, L = reads.shape
    want = scan.kmer_table_full_plain(dix, reads, lens, max_k)
    for name in ("shipped", "occ", "bounded"):
        fn = libs[(name, "kmer_table.cu")].lrsc_kmer_table_full
        for levels in (wx, None):
            f = torch.empty((max_k + 1, R, L), dtype=torch.int32, device="cuda")
            v = torch.empty((max_k + 1, R, L), dtype=torch.bool, device="cuda")
            args = scan.kmer_table_full_args(dix, reads, lens, max_k, levels, f, v)

            def call():
                assert fn(*args, stream()) == 0
            call()
            torch.cuda.synchronize()
            say(kernel="kmer_table_full", variant=name, pyramid=levels is not None,
                exact=bool(torch.equal(f, want[0]) and torch.equal(v, want[1])),
                device_ms=device_ms(call))
    for mk in (13, 19, 30, 40, max_k):
        say(kernel="kmer_table_full", variant="shipped", max_k=mk,
            device_ms=device_ms(lambda: scan.kmer_table_full(dix, reads, lens, mk, wx)),
            device_ms_without_pyramid=device_ms(
                lambda: scan.kmer_table_full(dix, reads, lens, mk)))
    pix = scan.plane_index_of(hix, wx)
    say(kernel="kmer_table_planes", device_ms=device_ms(
        lambda: scan.kmer_table_planes(pix, wx.wcache, reads, lens, max_k, wx.ck)))


def prep(libs, corr, wx, items, stream):
    """walk_prep's variants on the bank and on a 64-row batch launch, part
    by part."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import walk

    per_read = [(rid, seq, s) for _, chunk, sl in corr._device_seed_scan(items)
                for (rid, seq), s in zip(chunk, sl)]
    tasks, _ = corr._enumerate_walks(per_read)
    cfg = corr.cfg
    prim = [t for t in tasks if t.init_k >= cfg.CK
            and corr._task_fits(t.src, t.path, t.trg, t.dis, t.init_k)]

    def prep_in(sel, T, bank):
        q, t, a, _, kbt, kbr = walk._task_arrays(sel, cfg, T, bank)
        up = {k: torch.from_numpy(x).cuda() for k, x in a.items()}
        return (wx, torch.from_numpy(q).cuda(), up["q_len"], torch.from_numpy(t).cuda(),
                up["n_term"], up["init_k"], up["min_overlap"], cfg, kbt, kbr, bank)

    for label, kargs in (("bank", prep_in(prim, len(prim), True)),
                         ("batch", prep_in(prim[:40], 64, False))):
        want = walk.prep_plain(*kargs)
        for name in ("shipped", "occ", "bounded", "no-step"):
            fn = libs[(name, "walk.cu")].lrsc_walk_prep
            res = {}
            for part, bits in (("all", walk.PREP_ALL), ("codes", walk.PREP_CODES),
                               ("terminal", walk.PREP_TERM), ("chain_root", walk.PREP_CHAIN)):
                out = walk.prep_outputs(kargs[1].shape[0], cfg, "cuda")
                pa, da = walk.prep_args(*kargs, out, bits)

                def call():
                    assert fn(pa, da, stream()) == 0
                call()
                torch.cuda.synchronize()
                if bits == walk.PREP_ALL:
                    res["exact"] = all(bool(torch.equal(out[k], want[k])) for k in want)
                res[part] = device_ms(call)
            say(kernel="walk_prep", launch=label, T=int(kargs[1].shape[0]), variant=name,
                device_ms=res)


if __name__ == "__main__":
    sys.exit(main())
