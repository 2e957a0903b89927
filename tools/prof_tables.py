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
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

OUT = os.path.join(REPO, "build", "prof_tables")
SOURCES = ("kmer_table.cu", "walk.cu", "walk.cuh", "rank.cuh", "ladder.cuh")


def variant(name, edits):
    """build/prof_tables/<name>/ with the sources after the edits
    ((file, old, new), each old present)."""
    from longreadselfcorrect_tpu_torch.ops import cuda

    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in SOURCES:
        with open(os.path.join(cuda.CSRC, f)) as fh:
            text = fh.read()
        for ef, old, new in edits:
            if ef == f:
                assert old in text, (name, f, old)
                text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def build(specs):
    """{name: CDLL}: one nvcc per (name, directory, source), all at once."""
    from longreadselfcorrect_tpu_torch.ops import cuda

    procs = []
    for name, d, src in specs:
        out = os.path.join(d, src.replace(".cu", ".so"))
        procs.append((name, out, subprocess.Popen(
            [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-I", d, "-o", out, os.path.join(d, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log[-3000:]}")
        rep = [r for r in cs.ptxas_report(log) if r[0] in ("kmer_table_full", "walk_prep")]
        print(json.dumps({"ptxas": name, "kernels": rep}), flush=True)
        lib = ctypes.CDLL(out)
        for fn in ("lrsc_kmer_table_full", "lrsc_walk_prep"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = cuda._SIGNATURES[fn]
        libs[name] = lib
    return libs


def device_ms(fn):
    """Median device time of fn's kernels in 7 calls (chip_smoke.device_ms)."""
    return round(cs.device_ms(fn, reps=7), 4)


def say(**kw):
    print(json.dumps(kw), flush=True)


def main() -> int:
    import torch

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
    from longreadselfcorrect_tpu_torch.ops import scan, walk

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    cs.phase_device()
    occ = [("rank.cuh", "  const int pa = lo, pb = hi + 1;  // prefix lengths of the two ends",
            "  if (live) update_interval(blocks, ckpt, C, nb, sym, lo, hi);\n  return;\n"
            "  const int pa = lo, pb = hi + 1;")]
    bounded = [("kmer_table.cu", "__global__ void kmer_table_full_kernel(",
                "__global__ void __launch_bounds__(256, 4) kmer_table_full_kernel("),
               ("walk.cu", "__launch_bounds__(kPrepWarps * 32)\n",
                "__launch_bounds__(kPrepWarps * 32, 8)\n")]
    no_step = [("walk.cuh", "    wcache_get(ix, code, st);\n    from = P.CK;",
                "    wcache_get(ix, code, st);\n    from = P.CK;\n    n = P.CK;")]
    t0 = time.perf_counter()
    libs = build([(f"{name}/{src}", variant(name, edits), src)
                  for name, edits in (("shipped", []), ("occ", occ), ("bounded", bounded),
                                      ("no-step", no_step))
                  for src in ("kmer_table.cu", "walk.cu") if name != "no-step" or src == "walk.cu"])
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
        fn = libs[f"{name}/kmer_table.cu"].lrsc_kmer_table_full
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
            fn = libs[f"{name}/walk.cu"].lrsc_walk_prep
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
