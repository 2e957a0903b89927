#!/usr/bin/env python3
"""attributes, estimate_best and remove_hitchhiking on one CUDA card, build by build.

    python3 tools/prof_seedscan.py [--tree NAME=DIR ...] [--variants a,b,...]
                                   [--sass DIR]

Builds seedscan.cu as it is ("shipped"), text-edited copies of it
(variants() below) and, with --tree, the seedscan.cu of other checkouts
(DIR/longreadselfcorrect_tpu_torch/csrc, as NAME: `--tree
parent=build/parent` after `git archive <commit> | tar -x -C
build/parent`), each under build/prof_seedscan/, one nvcc each, all at
once, and prints each build's ptxas line for the three kernels (--sass
DIR also writes each build's SASS into DIR).  Then, on
chip_smoke.py's bench data (its phase 3: the 4 Mb / 30x index) and on
every 64-read chunk of phase 4's seed sets (8%, 15%, the error-free 7 kb
segment beside the 20 kb read, the N-run chunk), at the seed slots the
main path gives the chunk's width:

* attributes and estimate_best of every build, each held against its
  plain version, their event ms (chip_smoke.time_ms, median of 5), device
  ms (chip_smoke.device_ms: events queued behind a sleep kernel, median
  of 7) and chain floor: the device ms of the build's kernel on the
  chunk's longest read alone (attributes) and on the seed whose pole walks
  the most k steps alone (estimate_best, chip_smoke.longest_pole);
* remove_hitchhiking of every build, held against its plain version, its
  event and device ms and chain floor: the device ms of the build's kernel
  on the read whose seed has the most pairs within the radius alone
  (chip_smoke.longest_window);
* estimate_best's longest pole walk in k steps, remove_hitchhiking's
  longest window in pairs.

First, the card's L2 round trip (one thread chasing a random cycle of
128-byte lines through 16 MB, L1 bypassed: CHASE_CU) and the device ms of
that kernel with no load, which is what device_ms reads for any launch.

One JSON line per measurement, the card's name and power limit first.
Exits 1 if a build differs from the plain version (the variants that skip
work, INEXACT, are timed and their exactness printed, but not held to it).
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kernel_variants import REPO, build, cs, device_ms, say, variant  # noqa: E402

OUT = os.path.join(REPO, "build", "prof_seedscan")
SOURCES = ("seedscan.cu",)
ENTRIES = ("lrsc_attributes", "lrsc_estimate_best", "lrsc_remove_hitchhiking")
KERNELS = ("attributes", "estimate_best", "remove_hitchhiking")
INEXACT = ("hitch-noorder", "hitch-nowalk")  # variants that skip work: timed, not held

CHASE_CU = r"""
#include <cuda_runtime.h>
__global__ void chase_kernel(const int* __restrict__ next, int steps, int* out) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  *out = i;
}
extern "C" int lrsc_chase(const int* next, int steps, int* out, void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, out);
  return (int)cudaGetLastError();
}
"""


def l2_round_trip_us(steps: int = 50_000) -> tuple[float, float]:
    """Microseconds of one dependent load from L2 (CHASE_CU, built into
    build/prof_seedscan/chase/), and the device ms of the same one-thread
    kernel with no load."""
    import numpy as np
    import torch

    from longreadselfcorrect_tpu_torch.ops import cuda

    d = os.path.join(OUT, "chase")
    os.makedirs(d, exist_ok=True)
    src, so = os.path.join(d, "chase.cu"), os.path.join(d, "libchase.so")
    with open(src, "w") as fh:
        fh.write(CHASE_CU)
    subprocess.run([cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.lrsc_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p]
    lines = (16 << 20) // 128
    perm = np.random.default_rng(5).permutation(lines) * 32
    nxt = np.zeros(lines * 32, np.int32)
    nxt[perm] = np.roll(perm, -1)
    dev_next = torch.from_numpy(nxt).cuda()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(k):
        assert lib.lrsc_chase(dev_next.data_ptr(), k, out.data_ptr(), stream) == 0
    return (cs.device_ms(lambda: run(steps), reps=3) * 1e3 / steps,
            cs.device_ms(lambda: run(0), reps=7))


ATTR_HEAD = "    unsigned* __restrict__ scratch, int* __restrict__ out) {\n"
ATTR_SMEM = "  extern __shared__ unsigned attr_smem[];\n"
ATTR_MASK = "  unsigned* mask = scratch + (size_t)r * 8 * W;\n"
ATTR_LAUNCH = "  attributes_kernel<<<R, kAttrThreads, 0, (cudaStream_t)stream>>>(\n"
ATTR_SMEM_LAUNCH = """  const size_t shmem = (size_t)32 * ((L + 31) / 32);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attributes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  attributes_kernel<<<R, kAttrThreads, shmem, (cudaStream_t)stream>>>(
"""


HITCH_SIDE_BY_SIDE = """  bool hitch = false, down = t < nr, up = t < nr;
  for (int d = 1; (down || up) && !hitch; ++d) {
    const int q = max(t - d, 0), s = min(t + d, nr - 1);
    down &= t - d >= 0;
    up &= t + d < nr;
    const int eq = seed_end(starts, sizes, o + q), ss = __ldg(starts + o + s);
    const bool rq = reps[o + q], rs = reps[o + s];
    const float fq = (float)__ldg(freqs + o + q), fs = (float)__ldg(freqs + o + s);
    const bool nq = down && wrap_sub(st, eq) <= radius;
    const bool ns = up && wrap_sub(ss, en) <= radius;
    hitch = (nq & rq & (ft / fq < hh)) | (ns & rs & (fs / ft > inv_hh));
    if (ordered) {
      down = nq;
      up = ns;
    }
  }
"""
# the two walks one after the other: a step's records in one round of
# loads (LOADS_FIRST) or its freq and repeat flag only once the pair is in
# reach (BRANCHY)
HITCH_WALKS = """  bool hitch = false;
  if (t < nr) {
    for (int q = t - 1; q >= 0 && !hitch; --q) {
%s    }
    for (int s = t + 1; s < nr && !hitch; ++s) {
%s    }
  }
"""
HITCH_LOADS_FIRST = HITCH_WALKS % ("""      const bool near = wrap_sub(st, seed_end(starts, sizes, o + q)) <= radius;
      const bool rep = reps[o + q];
      const float fq = (float)__ldg(freqs + o + q);
      hitch = near & rep & (ft / fq < hh);
      if (!near && ordered) break;
""", """      const bool near = wrap_sub(__ldg(starts + o + s), en) <= radius;
      const bool rep = reps[o + s];
      const float fs = (float)__ldg(freqs + o + s);
      hitch = near & rep & (fs / ft > inv_hh);
      if (!near && ordered) break;
""")
HITCH_BRANCHY = HITCH_WALKS % ("""      if (wrap_sub(st, seed_end(starts, sizes, o + q)) > radius) {
        if (ordered) break;
        continue;
      }
      hitch = reps[o + q] && ft / (float)__ldg(freqs + o + q) < hh;
""", """      if (wrap_sub(__ldg(starts + o + s), en) > radius) {
        if (ordered) break;
        continue;
      }
      hitch = reps[o + s] && (float)__ldg(freqs + o + s) / ft > inv_hh;
""")
ORDER_UNROLL = "#pragma unroll 4\n  for (int b = 0; b < nr; b += 32) {"


def const(name, value):
    """The edit setting seedscan.cu's `constexpr int name` to value."""
    from longreadselfcorrect_tpu_torch.ops import cuda

    with open(os.path.join(cuda.CSRC, "seedscan.cu")) as fh:
        old = re.search(rf"constexpr int {name} = \d+;", fh.read()).group(0)
    return ("seedscan.cu", old, f"constexpr int {name} = {value};")


def variants():
    """name -> text edits of the shipped seedscan.cu; each variant computes
    the same outputs."""
    return {
        "shipped": [],
        # attributes: blocks of 512 threads; 1, 4 or 8 words' loads in flight a warp
        "attr-512": [const("kAttrThreads", 512)],
        "attr-words1": [const("kAttrWords", 1)],
        "attr-words4": [const("kAttrWords", 4)],
        "attr-words8": [const("kAttrWords", 8)],
        # attributes: the masks and prefixes in dynamic shared memory (opted
        # in past 48 KB) instead of the scratch row
        "attr-smem": [("seedscan.cu", ATTR_HEAD, ATTR_HEAD + ATTR_SMEM),
                      ("seedscan.cu", ATTR_MASK, "  unsigned* mask = attr_smem;\n"),
                      ("seedscan.cu", ATTR_LAUNCH, ATTR_SMEM_LAUNCH)],
        # the scratch row through a generic pointer (a select the compiler
        # cannot fold)
        "attr-generic": [("seedscan.cu", ATTR_HEAD, ATTR_HEAD + ATTR_SMEM),
                         ("seedscan.cu", ATTR_MASK, "  unsigned* mask = L < 0 ? attr_smem "
                          ": scratch + (size_t)r * 8 * W;\n")],
        # estimate_best: 32, 128 or 512 seed slots a block (512: one block for
        # each read of the bench's chunks, up to 16 poles a warp); 16 warps a block
        "best-slots32": [const("kBestSlots", 32)],
        "best-slots128": [const("kBestSlots", 128)],
        "best-slots512": [const("kBestSlots", 512)],
        "best-512": [const("kBestThreads", 512)],
        # remove_hitchhiking: 1 or 8 warps a block; every read's pairs all
        # tested (the order check made to fail: what the window saves)
        "hitch-warps1": [const("kHitchWarps", 1)],
        "hitch-warps8": [const("kHitchWarps", 8)],
        "hitch-allpairs": [("seedscan.cu", "  return !__any_sync(kFullMask, bad);",
                            "  return !__any_sync(kFullMask, bad) && nr < 0;")],
        # remove_hitchhiking without its order check, and without its walks
        # (neither is exact in general: they show what each part costs)
        "hitch-noorder": [("seedscan.cu", "  return !__any_sync(kFullMask, bad);",
                           "  return true;")],
        "hitch-nowalk": [("seedscan.cu", "(down || up) && !hitch;",
                          "(down || up) && !hitch && nr < 0;")],
        # remove_hitchhiking: the order check's loads 1, 8 or 16 rounds at
        # once
        **{f"hitch-order{u}": [("seedscan.cu", ORDER_UNROLL,
                                ORDER_UNROLL.replace("unroll 4", f"unroll {u}"))]
           for u in (1, 8, 16)},
        # remove_hitchhiking: the walks one after the other, a step's
        # records in one round of loads, or its freq and repeat flag only
        # once its pair is in reach
        "hitch-sequential": [("seedscan.cu", HITCH_SIDE_BY_SIDE, HITCH_LOADS_FIRST)],
        "hitch-branchy": [("seedscan.cu", HITCH_SIDE_BY_SIDE, HITCH_BRANCHY)],
    }


def main() -> int:
    import torch

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
    from longreadselfcorrect_tpu_torch.ops import cuda, scan, seedscan

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: the seedscan.cu of another checkout at DIR, built as NAME")
    ap.add_argument("--variants", default=",".join(variants()))
    ap.add_argument("--sass", metavar="DIR", help="write cuobjdump -sass of every build into DIR")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    cs.phase_device()
    names = [v for v in a.variants.split(",") if v]
    edits = variants()
    specs = [(n, variant(OUT, n, SOURCES, edits[n]), "seedscan.cu") for n in names]
    for tree in a.tree:
        name, root = tree.split("=", 1)
        tdir = os.path.join(root, "longreadselfcorrect_tpu_torch", "csrc")
        specs.append((name, variant(OUT, name, SOURCES, [], tdir), "seedscan.cu"))
        names = [name] + names
    t0 = time.perf_counter()
    libs = build(specs, KERNELS, ENTRIES)
    say(built_s=round(time.perf_counter() - t0, 1))
    if a.sass:
        os.makedirs(a.sass, exist_ok=True)
        tool = os.path.join(os.path.dirname(cuda.nvcc_path()), "cuobjdump")
        for name, d, _ in specs:
            with open(os.path.join(a.sass, f"sass_{name}.txt"), "w") as fh:
                subprocess.run([tool, "-sass", os.path.join(d, "seedscan.so")], stdout=fh,
                               stderr=subprocess.STDOUT)
    cuda.library("seedscan")
    if "seedscan" in cuda.BUILD_LOGS:
        say(ptxas="the package's seedscan.cu",
            kernels=[r for r in cs.ptxas_report(cuda.BUILD_LOGS["seedscan"]) if r[0] in KERNELS])
    l2_us, empty_ms = l2_round_trip_us()
    say(l2_round_trip_us=round(l2_us, 4), empty_launch_device_ms=round(empty_ms, 4))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    hix, dix, items, _, dp, seg, nchunk = cs.phase_data()
    params = CorrectionParams(pb_coverage=cs.COVERAGE, genome=10)
    corr = BatchedSelfCorrector(hix, dix, params)
    pp = corr.probe_params
    max_k = pp.kmer_len_up_bound + 1
    rep_thr = float(corr.thresh.get(2, pp.scan_kmer_len))
    bases = torch.arange(1, 5, dtype=torch.int8, device="cuda")
    bad = []
    sums = {}

    def attr_call(lib, fs, prefix, lens):
        """lib's attributes on [R, L] inputs: (launch, its output)."""
        R, L = fs.shape
        out = torch.full((R, L), 7, dtype=torch.int32, device="cuda")
        # [R, 4, L] words: the parent's scratch, and room for the [R, 8,
        # ceil(L/32)] masks of the later design
        scratch = torch.empty((R, 4, L), dtype=torch.int32, device="cuda")

        def call():
            assert lib.lrsc_attributes(fs.data_ptr(), prefix.data_ptr(), lens.data_ptr(), R,
                                       L, pp.scan_kmer_len, rep_thr, seedscan._RATIO_C,
                                       scratch.data_ptr(), out.data_ptr(), stream()) == 0
        return call, out

    def best_call(lib, freq, n, starts, sizes, statics):
        """lib's estimate_best: (launch, its outputs)."""
        K, R, L = freq.shape
        S = starts.shape[1]
        sk, ek = (torch.full((R, S), 7, dtype=torch.int32, device="cuda") for _ in range(2))
        oor = torch.ones((R, S), dtype=torch.bool, device="cuda")

        def call():
            assert lib.lrsc_estimate_best(
                freq.data_ptr(), n.data_ptr(), starts.data_ptr(), sizes.data_ptr(),
                statics.data_ptr(), K, R, L, S, pp.pb_coverage, sk.data_ptr(), ek.data_ptr(),
                oor.data_ptr(), stream()) == 0
        return call, (sk, ek, oor)

    hh, inv_hh = seedscan.hh_constants(float(pp.hh_ratio))

    def hitch_call(lib, n, starts, sizes, freqs, reps):
        """lib's remove_hitchhiking: (launch, its output)."""
        R, S = starts.shape
        keep = torch.ones((R, S), dtype=torch.bool, device="cuda")

        def call():
            assert lib.lrsc_remove_hitchhiking(
                n.data_ptr(), starts.data_ptr(), sizes.data_ptr(), freqs.data_ptr(),
                reps.data_ptr(), R, S, pp.radius, hh, inv_hh, keep.data_ptr(), stream()) == 0
        return call, keep

    for label, reads in (("8%", items), ("15%", dp), ("long", seg), ("N", nchunk)):
        for ci, (_, _, mat, lens_np) in enumerate(corr._seed_chunks(reads)):
            R, L = mat.shape
            dmat = torch.from_numpy(mat).cuda()
            lens = torch.from_numpy(lens_np).cuda()
            prefix = torch.zeros((R, L + 1, 4), dtype=torch.int32, device="cuda")
            torch.cumsum((dmat[:, :, None] == bases).to(torch.int32), dim=1,
                         dtype=torch.int32, out=prefix[:, 1:])
            freq, valid = scan.kmer_table_full(dix, dmat, lens, max_k, corr.wx)
            fscan = freq[pp.scan_kmer_len].contiguous()
            attr = seedscan.attributes_plain(fscan, prefix, lens, rep_thr, pp.scan_kmer_len)
            slots = seedscan.seed_slots(L, pp.start_kmer_len, pp.offset)
            seeds = seedscan.scan_automaton(
                freq, valid, attr, prefix, lens, corr._seed_thr, pp.start_kmer_len,
                pp.kmer_len_up_bound, tuple(pp.offset), float(pp.hh_ratio), slots)
            n, starts, sizes, freqs, reps, statics = seeds
            st = {}
            want_best = seedscan.estimate_best_plain(freq, n, starts, sizes, statics,
                                                     pp.pb_coverage, stats=st)
            steps = st["pole_steps"]
            r = int(lens.argmax())
            one_read = (fscan[r : r + 1], prefix[r : r + 1], lens[r : r + 1])
            pole = cs.longest_pole(freq, n, starts, sizes, statics, steps)
            hitch_args = (n, starts, sizes, freqs, reps)
            want_keep = seedscan.remove_hitchhiking_plain(*hitch_args, pp.radius,
                                                          float(pp.hh_ratio))
            window, most_pairs = cs.longest_window(*hitch_args, pp.radius)
            row = dict(set=label, chunk=ci, R=R, L=L, slots=slots, seeds=int(n.sum()),
                       most_seeds=int(n.max()), longest_walk=int(steps.max()),
                       walk_steps=st["walk_steps"], longest_window_pairs=most_pairs)
            for name in names:
                lib = libs[(name, "seedscan.cu")]
                res = {}
                call_attr, out = attr_call(lib, fscan, prefix, lens)
                call_best, got_best = best_call(lib, freq, n, starts, sizes, statics)
                call_hitch, keep = hitch_call(lib, *hitch_args)
                for k, call, check, floor in (
                        ("attributes", call_attr, lambda: torch.equal(out, attr),
                         attr_call(lib, *one_read)[0]),
                        ("estimate_best", call_best,
                         lambda: all(torch.equal(g, w) for g, w in zip(got_best, want_best)),
                         best_call(lib, *pole)[0]),
                        ("remove_hitchhiking", call_hitch, lambda: torch.equal(keep, want_keep),
                         hitch_call(lib, *window)[0])):
                    call()
                    torch.cuda.synchronize()
                    ok = check()
                    if not ok and name not in INEXACT:
                        bad.append(f"{k} {name} {label} chunk {ci}")
                    res[k] = dict(exact=bool(ok), ms=round(cs.time_ms(call), 4),
                                  device_ms=device_ms(call), chain_floor_ms=device_ms(floor))
                    key = (label, name, k)
                    sums[key] = sums.get(key, 0.0) + res[k]["device_ms"]
                row[name] = res
            say(**row)
    say(device_ms_by_set={f"{s} {n} {k}": round(v, 4) for (s, n, k), v in sums.items()})
    say(exact=not bad, mismatches=bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
