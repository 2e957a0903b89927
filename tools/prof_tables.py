#!/usr/bin/env python3
"""Where kmer_table_full's and walk_prep's time goes, on one CUDA card.

    python3 tools/prof_tables.py

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
             step: not exact, it shows what the steps cost).

Also kmer_table_full with max_k cut to 13, 19, 30 and 40, with and
without the pyramid (the levels' share of the time), kmer_table_planes on
the same chunk, and walk_prep's parts (the code rows, the terminal
windows, the chain ring with the root) alone.  One JSON line per
measurement, the card's name and power limit first.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_variants import REPO, build, cs, device_ms, say, variant  # noqa: E402

OUT = os.path.join(REPO, "build", "prof_tables")
SOURCES = ("kmer_table.cu", "walk.cu", "walk.cuh", "rank.cuh", "ladder.cuh")


def main() -> int:
    import torch

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
    from longreadselfcorrect_tpu_torch.ops import scan, walk

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
    t0 = time.perf_counter()
    libs = build([(name, variant(OUT, name, SOURCES, edits), src)
                  for name, edits in (("shipped", []), ("occ", occ), ("bounded", bounded),
                                      ("no-step", no_step))
                  for src in ("kmer_table.cu", "walk.cu") if name != "no-step" or src == "walk.cu"],
                 ("kmer_table_full", "walk_prep"), ("lrsc_kmer_table_full", "lrsc_walk_prep"))
    say(built_s=round(time.perf_counter() - t0, 1))
    hix, dix, items = cs.phase_data()[:3]
    corr = BatchedSelfCorrector(hix, dix, CorrectionParams(pb_coverage=cs.COVERAGE, genome=10))
    wx, stream = corr.wx, lambda: torch.cuda.current_stream().cuda_stream
    max_k = corr.probe_params.kmer_len_up_bound + 1
    _, _, mat, lens = next(corr._seed_chunks(items))
    reads, lens = torch.from_numpy(mat).cuda(), torch.from_numpy(lens).cuda()
    R, L = reads.shape

    # kmer_table_full on chunk 0
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

    # walk_prep on the bank and on a 64-row batch launch
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
