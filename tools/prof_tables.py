#!/usr/bin/env python3
"""Where kmer_table_full's, walk_prep's and kmer_freq_scan's time goes, on one CUDA card.

    python3 tools/prof_tables.py [--parts full,prep,freq] [--tree NAME=DIR ...]

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

One JSON line per measurement, the card's name and power limit first.
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
SOURCES = ("kmer_table.cu", "walk.cu", "walk.cuh", "rank.cuh", "ladder.cuh")


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


def takes_pyramid(directory) -> bool:
    """Whether the kmer_table.cu in directory has a kmer_freq_scan entry
    that takes the pyramid's tables (ck before the reads)."""
    with open(os.path.join(directory, "kmer_table.cu")) as fh:
        m = re.search(r'extern "C" int lrsc_kmer_freq_scan\(([^)]*)\)', fh.read())
    return "pyr_lower" in m.group(1)


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
                    help="full (kmer_table_full), prep (walk_prep), freq (kmer_freq_scan)")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: the kmer_table.cu of another checkout at DIR, for part freq")
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
    for tree in a.tree:
        name, root = tree.split("=", 1)
        dirs[name] = variant(OUT, name, SOURCES, [],
                             os.path.join(root, "longreadselfcorrect_tpu_torch", "csrc"))
        specs.append((name, dirs[name], "kmer_table.cu"))
    t0 = time.perf_counter()
    libs = build(specs, ("kmer_table_full", "walk_prep", "kmer_freq_scan"),
                 ("lrsc_kmer_table_full", "lrsc_walk_prep"))
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
