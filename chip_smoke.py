#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: build, exactness, speed.

    python3 chip_smoke.py

Phases, one line each on stdout (a failing phase raises and the script
exits non-zero without the final result line):

1. device   the card's name and power limit (nvidia-smi); no CUDA -> fail
2. build    the fifteen CUDA kernels from longreadselfcorrect_tpu_torch/csrc
            with nvcc, one process per source, all at once, and beside
            them native/fmbuild and native/alnscore.so (make); ptxas's
            registers, stack frame and spill bytes of the kernels of
            walk.cu, seedscan.cu and msa.cu
3. data     the bench corpus recipe: a 4 Mb random genome (seed 2026), 30x
            of 2 kb reads (60,000 reads, ~120M symbols per strand) indexed
            with native/fmbuild and packed (with the host-built 8-mer
            interval table); 256 noisy 1.5 kb reads at 8% error, and 2048
            further ones (seed 2027); 256 reads at 15% error, pbcorrect's
            default -e (seed 2028, its own stamp); all under .torch_cache/;
            then the walk's 12-mer interval table, four level-ups on the card
4. kernels  each seed-phase kernel against its plain torch version on the
            card, exactly, on every 64-read chunk of the 8% and the 15%
            reads and on a chunk holding an error-free 7 kb segment of the
            genome (its seeds overflow the JAX design's 128 seed slots; the
            slot kernels run there at 128 and at the main path's slot
            count) and a 20 kb read
            at 8% error (the automaton crosses its mask segments); kernel and plain
            times (CUDA events, median of 5 after one warm-up) and the least
            time the card needs for the same work on the first chunk;
            scan_automaton's time, its longest read's dependent rounds and
            the us per round on every chunk, and there the event and device
            times of attributes, estimate_best and remove_hitchhiking,
            estimate_best's longest pole walk (k steps, load rounds),
            remove_hitchhiking's most pairs in reach of one seed, and the
            chain floor of attributes, estimate_best and remove_hitchhiking:
            the device time of the kernel launched on the chunk's longest
            read alone, on the seed whose pole walks the most k steps
            alone, or on the read of the seed with the most pairs in reach
            alone; then remove_hitchhiking on two hand-made chunks, 64
            reads whose seeds are out of order and two reads of 18,016
            slots
5. walks    each walk kernel against its plain version on the card, on the
            gap tasks the 256 noisy reads enumerate, exactly: every
            level-up of the interval tables (8 -> 9 .. 11 -> 12, each with
            its index rows, event and device ms and bound), the prep of the
            bank, one superstep and a walk to
            completion of a 512-lane batch, the queue engine on 1024 tasks,
            each with the supersteps of its longest lane, the us per
            superstep, the warps resident per SM and the shared bytes per
            lane; then walk_steps and walk_queue at every further config the main
            path routes these tasks to (the bulk's narrow-chain bank, the
            batch buckets, the wide and dense reruns of flagged lanes), and
            an L = 32, a dense batch, each config of the ladder and the
            queue at the narrow-chain bank (KMAX 19) in any case
6. seeds    the port's seed phase on all 256 noisy reads on the card, held
            field for field against the host search_seeds on 16 of them;
            then on phase 4's two long reads, whose seeds overflow the JAX
            design's 128 seed slots (their chunk gets the slots that
            seed_slots sizes from its width), held the same way
7. tables   the seed phase's two other table routes, launch counts reset
            just before: the plane route (the index as bit-plane rows, then
            the seed phase with kmer_table_planes, chain seeded from the
            walk's 12-mer table) on all 256 reads and the wire route
            (_device_seed_tables, then the host search_seeds on those
            tables) on 16, both held against phase 6's seeds; the pool
            probe (kmer_freq_scan at pbcorrect's pool, kmer_freq_single at
            the scan k, both from the walk index's pyramid); then each of
            the four kernels against its plain version on every chunk and
            on both BWTs (kmer_freq_scan with the pyramid and without),
            exactly, and against kmer_table_full on the rows they share;
            times and bounds (kmer_freq_scan's also from level 1, its
            earlier route)
8. correct  pbcorrect end to end, launch counts reset just before: the
            walk's interval tables built anew (as on a first run over a
            pack), then BatchedSelfCorrector.process_stream over all 256
            noisy reads; the first 8 results held against the host
            SelfCorrector; reads/s of the stream, the tables' seconds, the
            seed/walks/replay split, the gaps, prefetch and host-fallback
            counters, the launches, and the configs walk_steps ran at (a
            config phase 5 did not check is checked now); the banded_fill
            calls of the pass recorded for phase 10
9. dp       the walk configs of the 15%-error reads' gap tasks checked as in
            phase 5; then process_stream over those reads, launch counts
            reset just before, the MSA kernels' calls recorded: reads/s, the
            split, the DP fallbacks (reached, succeeded, failed) and their
            seconds as a share of the replay, the launches (lf_extract and
            banded_fill must have run, lf_extract once per multiple
            alignment); the first 8 reads that reached the DP fallback held
            against the host SelfCorrector
10. msa     lf_extract against its plain version on every multiple
            alignment's grouped call, banded_fill on every call of phases 8
            and 9 (with its device ms and us per column), exactly; kernel
            and plain times on the median call, with the bound,
            lf_extract's us per dependent step and banded_fill's us per
            column and chain floor (one lane's column time at bw 31 times
            the call's columns), the whole banded_fill call and the
            download of its cells; per call the host
            route (numpy) against the card route (copies included): the
            crossover that sets the gates of core/msa.py; both routes of
            build_multiple_alignment on DP fallbacks of the path, consensus
            equal
12. throughput  the stream over the 2048 further reads, tables warm, four
            times: the DP fallback's loops in numpy, on the card, on the
            card, in numpy; the outputs equal; the seed kernels' launches
            of each turn
13. edge    the three inputs the port once got wrong, through
            process_stream on the card, launch counts reset just before:
            (a) the 8% set's first 64 reads with every other one
            lowercased, output and prefetch counters equal to the same
            reads upper case; (b) a stream whose last batch is 64 empty
            records, and one whose only batch is; (c) 64 reads of 15-52 bp
            cut from the genome at 8% error; each held against the host
            SelfCorrector (the lowercased reads on the first 4)
14. multiproc  pbcorrect --engine device --device cuda over the 2048
            further reads (-c 30 -g 10) as N = 1, 2 and 4 processes sharing
            the card (--num-processes): correct.fa, discard.fa and the
            summary byte-equal across N and to phase 12's results; per N
            the wall time, each rank's stream reads/s (its last "Processed
            n sequences in t s" line) and their sum, all reads over the
            span of the ranks' stream windows (first start to last end)
            and the time all N streamed at once, each rank's peak
            memory_allocated and launches, and os.cpu_count()
15. multigpu  entry.dryrun_multigpu over every visible card (NCCL; one rank
            in this process on a one-card machine), then sharded_multistep
            against the unsharded walk_steps on phase 5's 512-lane batch,
            bit for bit; the same with every rank's shard at world sizes 2
            and 4 walked on the card in this process, at G 512 and 509
            (padding lanes); the device time of a 13-float all_reduce; and
            parallel.distributed.global_counter_sum with its default device
            (the card: it all-reduces a cuda tensor) equal to its input
16. host    the host-only subcommands through the port's CLI, each a
            `python -m longreadselfcorrect_tpu_torch.cli` subprocess with
            PYTHONHASHSEED=0 under .torch_cache/host/: the PacBio hybrid
            pipeline (preprocess, index, correct, index, pbhc, index,
            fmwalk validate, filter, overlap, asmlong, with the index
            stages filter and overlap read) on tests/test_hybrid.py's
            corpus recipe at a 5 kb genome, then assemble, merge, oview,
            subgraph, grep, kmerfreq, kmercheck, and all (beside the
            rest); each stage's exit code 0 and the SHA-256 of its outputs
            equal to HOST_DIGESTS, the JAX CLI's on the same corpus; the
            pbhc pieces genome substrings, asmlong's longest contig 90% of
            the genome; each stage's wall seconds (host time)

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".torch_cache")
CORPUS_VERSION = "v2-4mb-30x"
GENOME_LEN = 4_000_000
READ_LEN = 2000
COVERAGE = 30
N_NOISY = 256
N_HOST_SEEDS = 16
N_HOST_CHECK = 8
N_STREAM = 2048       # further noisy reads for the steady-state throughput
DP_VERSION = "v1-15pct-2028"
N_DP = 256            # reads at pbcorrect's default error rate (-e 0.15)
DP_ERROR = 0.15
N_DP_CHECK = 8        # reads that reached the DP fallback, held against the host
SEG_START, SEG_LEN = 1_000_000, 7000  # the error-free genome segment of phase 4
LONG_START, LONG_LEN = 2_000_000, 20_000  # phase 4's long read (8% error)
MSA_CHECK_GATE = 32   # recorded lf_extract calls timed on both routes
MSA_GATE_FILL = 16    # recorded banded_fill calls timed on both routes
MSA_CHECK_PILEUPS = 16  # DP fallbacks run through both routes of the MSA
BATCH_READS = 64      # reads per stream batch (pbcorrect --batch-reads)
WALK_BATCH = 512
QUEUE_TASKS = 1024
QUEUE_LO_TASKS = 256  # queue check at the other bank configs
STEP_CHECK_TASKS = 64  # lanes of a walk_steps check at a further config
MAX_STEPS = 4096
REPS = 5

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor f32 op/s
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# kernel -> (source in the repo, the JAX function it replaces)
KERNEL_INFO = {
    "kmer_table_full": ("longreadselfcorrect_tpu_torch/csrc/kmer_table.cu",
                        "longreadselfcorrect_tpu/ops/scan.py:108"),
    "attributes": ("longreadselfcorrect_tpu_torch/csrc/seedscan.cu",
                   "longreadselfcorrect_tpu/ops/seedscan.py:53"),
    "scan_automaton": ("longreadselfcorrect_tpu_torch/csrc/seedscan.cu",
                       "longreadselfcorrect_tpu/ops/seedscan.py:97"),
    "estimate_best": ("longreadselfcorrect_tpu_torch/csrc/seedscan.cu",
                      "longreadselfcorrect_tpu/ops/seedscan.py:246"),
    "remove_hitchhiking": ("longreadselfcorrect_tpu_torch/csrc/seedscan.cu",
                           "longreadselfcorrect_tpu/ops/seedscan.py:303"),
    "wcache_level_up": ("longreadselfcorrect_tpu_torch/csrc/walk.cu",
                        "longreadselfcorrect_tpu/ops/walk.py:124"),
    "walk_prep": ("longreadselfcorrect_tpu_torch/csrc/walk.cu",
                  "longreadselfcorrect_tpu/ops/walk.py:371"),
    "walk_steps": ("longreadselfcorrect_tpu_torch/csrc/walk.cu",
                   "longreadselfcorrect_tpu/ops/walk.py:997"),
    "walk_queue": ("longreadselfcorrect_tpu_torch/csrc/walk.cu",
                   "longreadselfcorrect_tpu/ops/walk.py:1802"),
    "lf_extract": ("longreadselfcorrect_tpu_torch/csrc/msa.cu",
                   "longreadselfcorrect_tpu/ops/msa_kernels.py:36"),
    "banded_fill": ("longreadselfcorrect_tpu_torch/csrc/msa.cu",
                    "longreadselfcorrect_tpu/ops/msa_kernels.py:89"),
    "kmer_freq_scan": ("longreadselfcorrect_tpu_torch/csrc/kmer_table.cu",
                       "longreadselfcorrect_tpu/ops/scan.py:32"),
    "kmer_table_wire": ("longreadselfcorrect_tpu_torch/csrc/kmer_table.cu",
                        "longreadselfcorrect_tpu/ops/scan.py:143"),
    "plane_rows": ("longreadselfcorrect_tpu_torch/csrc/planes.cu",
                   "longreadselfcorrect_tpu/ops/scan.py:212"),
    "kmer_table_planes": ("longreadselfcorrect_tpu_torch/csrc/planes.cu",
                          "longreadselfcorrect_tpu/ops/scan.py:276"),
}
SEED_KERNELS = ("kmer_table_full", "attributes", "scan_automaton", "estimate_best",
                "remove_hitchhiking")
WALK_KERNELS = ("wcache_level_up", "walk_prep", "walk_steps", "walk_queue")
MSA_KERNELS = ("lf_extract", "banded_fill")
TABLE_KERNELS = ("kmer_freq_scan", "kmer_table_wire", "plane_rows", "kmer_table_planes")


class PhaseError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise PhaseError("device: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(f"device: {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    say(smi)
    return name, smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def ptxas_report(log: str) -> list:
    """[kernel, registers, stack frame bytes, spill store bytes, spill load
    bytes] of each entry function of an nvcc -Xptxas -v log."""
    out, name, frame = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z_]+)_kernel(?:ILi(\d+)E)?", m.group(1))
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")) if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = [int(x) for x in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append([name, int(m.group(1))] + (frame or [0, 0, 0]))
            name, frame = None, None
    return out


def phase_build():
    from longreadselfcorrect_tpu_torch.ops import cuda

    # the host helpers, built beside the kernels: fmbuild (phase 3's index,
    # phase 16's index stages) and alnscore.so (pbhc's aligner in phase 16);
    # not hashorder.so, since phase 16's digests were taken without it
    t0 = time.perf_counter()
    make = subprocess.Popen(["make", "-C", os.path.join(REPO, "native"), "fmbuild",
                             "alnscore.so"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        paths = cuda.build()
        for lib in cuda.SOURCES:
            cuda.library(lib)
        say(f"build: {len(paths)} libraries ({len(cuda.KERNELS)} kernels) for sm_90a "
            f"in {time.perf_counter() - t0:.2f}s")
        for lib, first in (("walk", "walk_steps<4>"), ("seedscan", "scan_automaton"),
                           ("msa", "lf_extract"), ("kmer_table", "kmer_table_full")):
            if lib in cuda.BUILD_LOGS:
                rep = ptxas_report(cuda.BUILD_LOGS[lib])
                say(f"build: {lib}.cu ptxas (kernel, registers, stack frame B, spill stores B, "
                    f"spill loads B): {json.dumps(rep)}")
                check(any(r[0] == first for r in rep), f"build: no ptxas report for {first}")
            else:
                say(f"build: {lib}.cu was built by an earlier run: no ptxas report")
    except BaseException:
        make.kill()
        make.wait()
        raise
    _, err = make.communicate()
    check(make.returncode == 0, f"build: make -C native fmbuild alnscore.so: {err[-2000:]}")
    say(f"build: native/fmbuild and native/alnscore.so (make -C native fmbuild alnscore.so) "
        f"done {time.perf_counter() - t0:.2f}s after the start")


# ---------------------------------------------------------------------------
# phase 3: data (bench.py's corpus recipe)
# ---------------------------------------------------------------------------

def noisify(rng, s, e):
    out = []
    for ch in s:
        r = rng.random()
        if r < e * 0.6:
            out.append("ACGT"[("ACGT".index(ch) + int(rng.integers(1, 4))) % 4])
        elif r < e * 0.8:
            pass
        elif r < e:
            out.append(ch)
            out.append("ACGT"[int(rng.integers(0, 4))])
        else:
            out.append(ch)
    return "".join(out)


def make_genome(rng) -> str:
    """The bench genome: the first draw of rng seed 2026."""
    return "".join(rng.choice(list("ACGT"), size=GENOME_LEN))


def ensure_dp_reads() -> str:
    """The DP read set: 1.5 kb reads of the same genome at 15% error (rng
    seed 2028), under a stamp of its own, so that neither the corpus nor
    its index is rebuilt."""
    import numpy as np

    stamp = os.path.join(CACHE, DP_VERSION + ".ok")
    path = os.path.join(CACHE, "dp.fa")
    if os.path.exists(stamp):
        return path
    genome = make_genome(np.random.default_rng(2026))
    rng = np.random.default_rng(2028)
    with open(path, "w") as f:
        for i, p in enumerate(rng.integers(0, GENOME_LEN - 1600, size=N_DP)):
            f.write(f">d{i}\n{noisify(rng, genome[p : p + 1500], DP_ERROR)}\n")
    with open(stamp, "w") as f:
        f.write("ok")
    return path


def ensure_corpus():
    import numpy as np

    from longreadselfcorrect_tpu_torch.core import alphabet as ab

    os.makedirs(CACHE, exist_ok=True)
    stamp = os.path.join(CACHE, CORPUS_VERSION + ".ok")
    corpus = os.path.join(CACHE, "corpus.fa")
    noisy = os.path.join(CACHE, "noisy.fa")
    stream = os.path.join(CACHE, "stream.fa")
    if os.path.exists(stamp):
        return corpus, noisy, stream
    rng = np.random.default_rng(2026)
    genome = make_genome(rng)
    n_reads = GENOME_LEN * COVERAGE // READ_LEN
    with open(corpus, "w") as f:
        for i in range(n_reads):
            p = int(rng.integers(0, GENOME_LEN - READ_LEN))
            r = genome[p : p + READ_LEN]
            if i % 2:
                r = ab.revcomp_str(r)
            f.write(f">c{i}\n{r}\n")
    with open(noisy, "w") as f:
        for i, p in enumerate(rng.integers(0, GENOME_LEN - 1600, size=N_NOISY)):
            f.write(f">r{i}\n{noisify(rng, genome[p : p + 1500], 0.08)}\n")
    rng = np.random.default_rng(2027)
    with open(stream, "w") as f:
        for i, p in enumerate(rng.integers(0, GENOME_LEN - 1600, size=N_STREAM)):
            f.write(f">s{i}\n{noisify(rng, genome[p : p + 1500], 0.08)}\n")
    with open(stamp, "w") as f:
        f.write("ok")
    return corpus, noisy, stream


def phase_data():
    from longreadselfcorrect_tpu_torch.index import store
    from longreadselfcorrect_tpu_torch.index.pack import open_index
    from longreadselfcorrect_tpu_torch.io import fasta

    t0 = time.perf_counter()
    corpus, noisy, stream = ensure_corpus()
    t_corpus = time.perf_counter() - t0
    prefix = os.path.join(CACHE, "corpus")
    t0 = time.perf_counter()
    if not os.path.exists(prefix + ".bwtraw"):
        if store.fmbuild_path() is None:
            subprocess.run(["make", "-C", os.path.join(REPO, "native"), "fmbuild"],
                           check=True, capture_output=True)
        store.build_with_fmbuild(corpus, prefix)
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    hix, dix = open_index(prefix, device="cuda")
    t_pack = time.perf_counter() - t0
    items = [(rec.id, rec.seq) for rec in fasta.read_seqs(noisy)]
    check(len(items) == N_NOISY, f"data: {len(items)} noisy reads")
    extra = [(rec.id, rec.seq) for rec in fasta.read_seqs(stream)]
    check(len(extra) == N_STREAM, f"data: {len(extra)} further noisy reads")
    t0 = time.perf_counter()
    dp = [(rec.id, rec.seq) for rec in fasta.read_seqs(ensure_dp_reads())]
    t_dp = time.perf_counter() - t0
    check(len(dp) == N_DP, f"data: {len(dp)} reads at {DP_ERROR:.0%} error")
    dev_mb = sum(t.numel() * t.element_size()
                 for fm in (dix.bwt, dix.rbwt) for t in (fm.blocks, fm.ckpt, fm.C)) / 1e6
    say(f"data: genome {GENOME_LEN} bp, {GENOME_LEN * COVERAGE // READ_LEN} reads, "
        f"{hix.bwt.n} symbols per strand, device index {dev_mb:.1f} MB, "
        f"{len(items)} noisy reads (max {max(len(s) for _, s in items)} bp) and "
        f"{len(extra)} further ones; {len(dp)} reads at {DP_ERROR:.0%} error "
        f"(max {max(len(s) for _, s in dp)} bp, in {t_dp:.1f}s); "
        f"corpus {t_corpus:.1f}s, fmbuild {t_index:.1f}s, pack+upload {t_pack:.1f}s")
    import torch

    from longreadselfcorrect_tpu_torch.ops import walk

    t0 = time.perf_counter()
    wc8 = walk.get_wcache(dix, hix, walk.CACHE_K)
    torch.cuda.synchronize()
    t8 = time.perf_counter() - t0
    ck = walk.walk_ck(hix.bwt.n)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wx = walk.WalkIndex.build(dix, hix, ck)
    torch.cuda.synchronize()
    t12 = time.perf_counter() - t0
    held = (torch.cuda.memory_allocated() - base) / 1e6
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    say(f"data: walk interval tables: ck=8 {tuple(wc8.shape)} from the pack in "
        f"{t8:.3f}s; ck={ck} {tuple(wx.wcache.shape)} = "
        f"{wx.wcache.numel() * 4 / 1e6:.1f} MB and the pyramid of levels 1..{ck - 1} "
        f"{tuple(wx.pyramid.shape)} = {wx.pyramid.numel() * 4 / 1e6:.1f} MB, by "
        f"{ck - walk.CACHE_K} level-ups on the card (+ saving wcache{ck}.npy) in "
        f"{t12:.3f}s; device memory held by the two {held:.1f} MB "
        f"(torch.cuda.memory_allocated), peak during the build +{peak:.1f} MB "
        f"(max_memory_allocated)")
    check(wx.pyramid.numel() * 4 <= 100e6, "data: the pyramid is over 100 MB")
    # an error-free 7 kb segment of the genome, whose seeds overflow the
    # 128 seed slots of the automaton, and a 20 kb read at 8% error, whose
    # automaton crosses two of the kernel's 8192-position mask segments
    import numpy as np

    genome = make_genome(np.random.default_rng(2026))
    long_read = noisify(np.random.default_rng(2029),
                        genome[LONG_START : LONG_START + LONG_LEN], 0.08)
    return (hix, dix, items, extra, dp,
            [("g7k", genome[SEG_START : SEG_START + SEG_LEN]), ("n20k", long_read)],
            n_chunk(genome))


def n_chunk(genome):
    """64 reads of the genome at 8% error for phase 4 (rng seed 2030) that
    the bench sets lack: N runs (rank 0) in the first 12 symbols of many
    lanes and at a read's first position, reads of 1 to 24 bp, and a read
    of 1536, the chunk's width."""
    import numpy as np

    rng = np.random.default_rng(2030)
    out = []
    for i in range(64):
        if i == 0:
            p = int(rng.integers(0, GENOME_LEN - 1536))
            s = list(noisify(rng, genome[p : p + 2000], 0.08)[:1536])
        elif i <= 7:
            n = (1, 2, 5, 11, 12, 13, 24)[i - 1]
            p = int(rng.integers(0, GENOME_LEN - n))
            s = list(genome[p : p + n])
        else:
            p = int(rng.integers(0, GENOME_LEN - 1600))
            s = list(noisify(rng, genome[p : p + int(rng.integers(200, 1400))], 0.08))
        if i % 2 == 0 and len(s) > 1:
            for q in rng.choice(len(s), size=min(len(s), 6), replace=False):
                k = int(rng.integers(1, 4))
                s[q : q + k] = ["N"] * len(s[q : q + k])
            s[0] = "N" if i % 4 == 0 else s[0]
        out.append((f"n{i}", "".join(s)))
    return out


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(fn, reps=REPS):
    """Median CUDA-event time of fn over `reps` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=REPS):
    """Median device time of fn's kernels over `reps` calls after one
    warm-up: the events around each call are queued behind a ~1.5 ms sleep
    kernel, so the host's work in the call (arguments, output tensors, the
    launch) is done before the device reaches them, and the time between
    them is the device's alone (time_ms's events take in that host time
    when the call is shorter than it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(3_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    return err


def rank_traffic(ix, reads, max_k, state=None, j0=1):
    """(distinct index rows, rank queries, row loads) the k-mer table of
    this chunk needs from level j0 (an int, or a tensor: each lane's own
    level; state: the lanes' intervals there, level 1's by default) to
    max_k: two queries per live step of each still-valid strand, as the
    kernels issue them; a step whose two ends share a block loads one row
    in kmer_table_full (rank.cuh update_interval_shared), two otherwise."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import rank

    sym0 = reads.long()
    R, L = reads.shape
    if state is None:
        state = rank.init_bi(ix, sym0.clamp(0, 4))
    state = list(state)
    j0 = torch.as_tensor(j0, device=reads.device).expand(R, L)
    seen = {id(fm): torch.zeros(fm.blocks.shape[0], dtype=torch.bool,
                                device=reads.device) for fm in (ix.rbwt, ix.bwt)}
    queries = loads = 0
    for j in range(int(j0.min()), max_k):
        nxt = torch.full((R, L), 5, dtype=torch.long, device=reads.device)
        nxt[:, : L - j] = sym0[:, j:]
        live = (nxt < 5) & (j >= j0)
        s = nxt.clamp(0, 4)
        for fm, lo_i, sym in ((ix.rbwt, 0, s), (ix.bwt, 2, rank.comp(s))):
            lo, hi = state[lo_i], state[lo_i + 1]
            need = live & (lo <= hi)
            queries += 2 * int(need.sum())
            same = torch.div(lo, fm.block, rounding_mode="floor") == torch.div(
                hi + 1, fm.block, rounding_mode="floor")
            loads += int((need & same).sum()) + 2 * int((need & ~same).sum())
            for idx in (lo[need] - 1, hi[need]):
                q = torch.div(idx + 1, fm.block, rounding_mode="floor")
                seen[id(fm)][q.clamp(0, fm.blocks.shape[0] - 1).long()] = True
            nlo, nhi = rank.update_interval(fm, lo, hi, sym)
            state[lo_i] = torch.where(live, nlo, lo)
            state[lo_i + 1] = torch.where(live, nhi, hi)
    rows = sum(int(m.sum()) for m in seen.values())
    return rows, queries, loads


def pyramid_start(wx, reads, max_k, pool=None):
    """Each lane's start in kmer_table_full (or, given a pool,
    kmer_freq_scan) with the walk index's pyramid: (c: its clean prefix,
    the leading symbols in 1..4 inside the row, at most ck and max_k; the
    lanes' intervals at level max(c, 1); the distinct pyramid entries the
    lanes read: every level up to c, or the pool's levels up to c and c)."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import rank

    R, L = reads.shape
    sym0 = reads.long()
    ok = torch.ones((R, L), dtype=torch.bool, device=reads.device)
    c = torch.zeros((R, L), dtype=torch.long, device=reads.device)
    code = torch.zeros((R, L), dtype=torch.long, device=reads.device)
    codes = []   # the code of each lane's first j symbols, j = 1..cmax
    for i in range(min(wx.ck, max_k)):
        s = torch.full((R, L), 5, dtype=torch.long, device=reads.device)
        s[:, : L - i] = sym0[:, i:]
        ok = ok & (s >= 1) & (s <= 4)
        c += ok.long()
        code = torch.where(ok, code * 4 + s - 1, code)
        codes.append(code)
    state = torch.stack(rank.init_bi(wx.ix, sym0.clamp(0, 4)), dim=-1)
    entries = 0
    for j in range(1, len(codes) + 1):
        have = c >= j if pool is None or j in pool else c == j
        entries += int(torch.unique(codes[j - 1][have]).numel())
        at = c == j
        state[at] = wx.level(j)[codes[j - 1][at]]
    return c, tuple(state[..., i] for i in range(4)), entries


def ladder_traffic(ix, wcache, ck, syms, n, table):
    """(rank queries, row loads, distinct index rows) of LF ladders, each
    the interval of syms[i, :n[i]] (symbols 1..4) appended left to right,
    started from the ck-mer table where table and n >= ck, else from
    level 1, both strands stepped raw as walk_prep steps them; a step's
    two ends in one block load one row (rank.cuh update_interval_shared)."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import rank

    dev = syms.device
    use_t = (n >= ck) & table
    code = torch.zeros(syms.shape[0], dtype=torch.long, device=dev)
    for j in range(ck):
        code = code * 4 + (syms[:, j] - 1).clamp(0, 3)
    t = wcache[torch.where(use_t, code, 0)]
    st = list(rank.init_bi(ix, syms[:, 0]))
    state = [torch.where(use_t, t[:, i], st[i]) for i in range(4)]
    start = torch.where(use_t, ck, 1)
    seen = {id(fm): torch.zeros(fm.blocks.shape[0], dtype=torch.bool, device=dev)
            for fm in (ix.rbwt, ix.bwt)}
    queries = loads = 0
    for j in range(1, int(n.max())):
        live = (j >= start) & (j < n)
        s = syms[:, j]
        for fm, lo_i, sym in ((ix.rbwt, 0, s), (ix.bwt, 2, rank.comp(s))):
            lo, hi = state[lo_i], state[lo_i + 1]
            queries += 2 * int(live.sum())
            same = torch.div(lo, fm.block, rounding_mode="floor") == torch.div(
                hi + 1, fm.block, rounding_mode="floor")
            loads += int((live & same).sum()) + 2 * int((live & ~same).sum())
            for idx in (lo[live] - 1, hi[live]):
                q = torch.div(idx + 1, fm.block, rounding_mode="floor")
                seen[id(fm)][q.clamp(0, fm.blocks.shape[0] - 1).long()] = True
            nlo, nhi = rank.update_interval(fm, lo, hi, sym)
            state[lo_i] = torch.where(live, nlo, lo)
            state[lo_i + 1] = torch.where(live, nhi, hi)
    return queries, loads, sum(int(m.sum()) for m in seen.values())


def prep_traffic(wx, kargs):
    """(rank queries, row loads, distinct index rows) of walk_prep's
    ladders on these arguments (walk._prep_kernel's): the terminal windows
    m < n_term, the chain slots CK + i <= init_k, the root where no slot
    holds it (csrc/walk.cuh prep_task)."""
    import torch

    _, query, _, trg, n_term, init_k, mo, cfg, kbt, kbr, use_wc = kargs
    CK, NC, dev = cfg.CK, cfg.NCHAIN, query.device
    table = tuple(wx.wcache.shape) == (4 ** CK, 4)
    q14 = query.long().clamp(1, 4)
    t14 = trg.long().clamp(1, 4)
    T, QW = q14.shape
    ik, nt = init_k.long(), n_term.long().clamp(0, cfg.TMAX)
    lo_len = CK if use_wc else 1
    W = max(kbt, kbr, CK) + 1
    j = torch.arange(W, device=dev)
    rows, lens = [], []
    # terminal windows
    m = torch.arange(cfg.TMAX, device=dev)
    keep = m[None, :] < nt[:, None]
    tt, mm = keep.nonzero(as_tuple=True)
    pos = (mm[:, None] + j[None, :]).clamp(max=t14.shape[1] - 1)
    rows.append(t14[tt[:, None], pos])
    lens.append(torch.clamp(torch.minimum(torch.full_like(tt, kbt), mo.long()[tt]), min=lo_len))
    # chain slots and the roots no slot holds
    i = torch.arange(NC, device=dev)
    keep = (CK + i)[None, :] <= ik[:, None]
    tc, ic = keep.nonzero(as_tuple=True)
    start = ik[tc] - (CK + ic)
    rows.append(q14[tc[:, None], (start[:, None] + j[None, :]).clamp(0, QW - 1)])
    chain_n = torch.clamp(CK + ic, max=max(kbr, CK))
    lens.append(chain_n)
    root_n = torch.clamp(torch.clamp(ik, max=kbr), min=lo_len)
    slot_n = torch.clamp(ik, max=max(kbr, CK))
    reuse = (ik >= CK) & (ik - CK < NC) & (root_n == slot_n)
    tr = (~reuse).nonzero(as_tuple=True)[0]
    rows.append(q14[tr[:, None], j[None, :].clamp(max=QW - 1)])
    lens.append(root_n[tr])
    syms, n = torch.cat(rows), torch.cat(lens)
    return ladder_traffic(wx.ix, wx.wcache, CK, syms, n, table)


def bound(nbytes: float, nops: float):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / SCALAR_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def longest_pole(freq, n, starts, sizes, statics, pole_steps):
    """estimate_best's inputs cut to the one seed whose pole walks the most
    k steps (pole_steps: estimate_best_plain's stats["pole_steps"]): its
    read's rows of freq, n = 1 and the seed's records in slot 0."""
    import numpy as np

    _, r, j = (int(i) for i in np.unravel_index(int(pole_steps.argmax()), pole_steps.shape))
    return (freq[:, r : r + 1].contiguous(), n.new_ones(1),
            *(t[r : r + 1, j : j + 1].contiguous() for t in (starts, sizes, statics)))


def hitch_windows(n, starts, sizes, radius):
    """int64 [R, S]: the pairs within the radius that each valid seed slot
    is in, as query or as subject (remove_hitchhiking's pair mask, summed
    over the other slot)."""
    import torch

    R, S = starts.shape
    dev = starts.device
    idx = torch.arange(S, device=dev)
    ends = starts + sizes - 1
    out = torch.zeros((R, S), dtype=torch.int64, device=dev)
    step = max(1, (1 << 24) // (S * S))
    for a in range(0, R, step):
        b = min(R, a + step)
        valid = idx[None, :] < n[a:b, None]
        pair = ((idx[None, None, :] > idx[None, :, None]) & valid[:, :, None]
                & valid[:, None, :] & (starts[a:b, None, :] - ends[a:b, :, None] <= radius))
        out[a:b] = pair.sum(2) + pair.sum(1)
    return out


def longest_window(n, starts, sizes, freqs, reps, radius):
    """remove_hitchhiking's inputs cut to the read whose seed has the most
    pairs within the radius (hitch_windows), and that count."""
    win = hitch_windows(n, starts, sizes, radius)
    r = int(win.max(dim=1).values.argmax())
    return (n[r : r + 1].contiguous(),
            *(t[r : r + 1].contiguous() for t in (starts, sizes, freqs, reps))), int(win.max())


def hitch_records(seed, R, S, n, shuffle, dev):
    """remove_hitchhiking's inputs for a hand-made chunk: R reads of n[r]
    seeds in order (15-39 long, 0-149 apart), freqs 1-399, a third of the
    seeds repeats; shuffle puts each read's records out of order."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sizes = rng.integers(15, 40, (R, S))
    gaps = rng.integers(0, 150, (R, S))
    starts = np.cumsum(sizes + gaps, axis=1) - sizes - gaps
    if shuffle:
        for r in range(R):
            perm = rng.permutation(S)
            starts[r], sizes[r] = starts[r, perm], sizes[r, perm]
    freqs = rng.integers(1, 400, (R, S))
    reps = rng.random((R, S)) < 0.3
    return (torch.tensor(n, dtype=torch.int32, device=dev),
            *(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (starts, sizes, freqs)),
            torch.from_numpy(reps).to(dev))


def hand_hitch_chunks(radius, hh, dev):
    """remove_hitchhiking against its plain version on records the
    automaton never emits: 64 reads whose starts are out of order (every
    pair tested), and two reads of 18,016 slots, past the ~17,900 that a
    block's shared memory held in the kernel's earlier design."""
    import numpy as np

    from longreadselfcorrect_tpu_torch.ops import seedscan

    out = []
    for label, (seed, R, S, n, shuffle) in (
            ("unsorted", (2031, 64, 128, np.random.default_rng(2032).integers(0, 129, 64),
                          True)),
            ("wide", (2033, 2, 18016, [18016, 12000], False))):
        ins = hitch_records(seed, R, S, n, shuffle, dev)
        e = max_abs_err(seedscan.remove_hitchhiking(*ins, radius, hh),
                        seedscan.remove_hitchhiking_plain(*ins, radius, hh))
        out.append(dict(chunk=label, R=R, slots=S, seeds=int(ins[0].sum()), err=e,
                        device_ms=round(device_ms(
                            lambda: seedscan.remove_hitchhiking(*ins, radius, hh)), 4)))
    return out


def phase_kernels(corrector, sets):
    """Every kernel against its plain version on every 64-read chunk of
    each read set (name, items); times and bounds on the first set's chunk
    0; scan_automaton's time and dependent rounds on every chunk.  Returns
    {kernel: record}."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import cuda, scan, seedscan

    pp = corrector.probe_params
    ix = corrector.dix
    dev = ix.device
    max_k = pp.kmer_len_up_bound + 1
    K = max_k + 1
    thr = corrector._seed_thr
    rep_thr = float(corrector.thresh.get(2, pp.scan_kmer_len))
    hh = float(pp.hh_ratio)
    bases = torch.arange(1, 5, dtype=torch.int8, device=dev)
    err = {k: 0 for k in SEED_KERNELS}
    rec = {}
    auto_chunks = []   # scan_automaton per chunk: set, ms, longest chain
    table_chunks = []  # kmer_table_full per chunk
    wx = corrector.wx
    cuda.reset_launches()
    chunks = [(name, ci, mat, lens_np) for name, items in sets
              for ci, (_, _, mat, lens_np) in enumerate(corrector._seed_chunks(items))]
    for name, ci, mat, lens_np in chunks:
        R, L = mat.shape
        reads = torch.from_numpy(mat).to(dev)
        lens = torch.from_numpy(lens_np).to(dev)
        prefix = torch.zeros((R, L + 1, 4), dtype=torch.int32, device=dev)
        torch.cumsum((reads[:, :, None] == bases).to(torch.int32), dim=1,
                     dtype=torch.int32, out=prefix[:, 1:])

        calls = {
            "kmer_table_full": (
                lambda: scan.kmer_table_full(ix, reads, lens, max_k, wx),
                lambda: scan.kmer_table_full_plain(ix, reads, lens, max_k)),
        }
        freq, valid = calls["kmer_table_full"][0]()
        e = max_abs_err((freq, valid), calls["kmer_table_full"][1]())
        err["kmer_table_full"] = max(err["kmer_table_full"], e)
        table_chunks.append(dict(set=name, chunk=ci, L=L, err=e,
                                 ms=round(time_ms(calls["kmer_table_full"][0]), 4),
                                 device_ms=round(device_ms(calls["kmer_table_full"][0]), 4)))
        fscan = freq[pp.scan_kmer_len]
        calls["attributes"] = (
            lambda: seedscan.attributes(fscan, prefix, lens, rep_thr, pp.scan_kmer_len),
            lambda: seedscan.attributes_plain(fscan, prefix, lens, rep_thr,
                                              pp.scan_kmer_len))
        attr = calls["attributes"][0]()
        err["attributes"] = max(err["attributes"],
                                max_abs_err(attr, calls["attributes"][1]()))
        # the chain floor: one block's chain, the longest read alone
        r = int(lens.argmax())
        one = (fscan[r : r + 1], prefix[r : r + 1], lens[r : r + 1])
        attr_times = dict(attr_ms=round(time_ms(calls["attributes"][0]), 4),
                          attr_device_ms=round(device_ms(calls["attributes"][0]), 4),
                          attr_floor_ms=round(device_ms(lambda: seedscan.attributes(
                              *one, rep_thr, pp.scan_kmer_len)), 4))
        auto_args = (freq, valid, attr, prefix, lens, thr, pp.start_kmer_len,
                     pp.kmer_len_up_bound, tuple(pp.offset), hh)
        # the seed slots the main path gives this width, and on a wider
        # chunk also the JAX design's 128, whose last slot is overwritten
        slots = seedscan.seed_slots(L, pp.start_kmer_len, pp.offset)
        for smax in sorted({slots, seedscan.SMAX}, reverse=True):
            auto_stats: dict = {}
            calls["scan_automaton"] = (
                lambda: seedscan.scan_automaton(*auto_args, smax),
                lambda: seedscan.scan_automaton_plain(*auto_args, smax))
            rounds = torch.zeros(R, dtype=torch.int32, device=dev)
            auto = seedscan.scan_automaton(*auto_args, smax, rounds=rounds)
            err["scan_automaton"] = max(err["scan_automaton"], max_abs_err(
                auto, seedscan.scan_automaton_plain(*auto_args, smax, stats=auto_stats)))
            n, starts, sizes, freqs, reps, statics = auto
            check(smax < slots or int(n.max()) < smax,
                  f"kernels: a read filled the {smax} slots of its {L}-wide chunk")
            a_ms = time_ms(calls["scan_automaton"][0])
            auto_chunks.append(dict(set=name, chunk=ci, L=L, slots=smax, ms=round(a_ms, 4),
                                    rounds=int(rounds.max()), seeds=int(n.sum()),
                                    full=int((n == smax).sum()),
                                    us_per_round=round(a_ms * 1e3 / max(int(rounds.max()), 1),
                                                       3),
                                    iterations=auto_stats["lane_steps"]))
            best_stats: dict = {}
            calls["estimate_best"] = (
                lambda: seedscan.estimate_best(freq, n, starts, sizes, statics,
                                               pp.pb_coverage),
                lambda: seedscan.estimate_best_plain(freq, n, starts, sizes, statics,
                                                     pp.pb_coverage))
            err["estimate_best"] = max(err["estimate_best"], max_abs_err(
                calls["estimate_best"][0](),
                seedscan.estimate_best_plain(freq, n, starts, sizes, statics,
                                             pp.pb_coverage, stats=best_stats)))
            calls["remove_hitchhiking"] = (
                lambda: seedscan.remove_hitchhiking(n, starts, sizes, freqs, reps,
                                                    pp.radius, hh),
                lambda: seedscan.remove_hitchhiking_plain(n, starts, sizes, freqs, reps,
                                                          pp.radius, hh))
            err["remove_hitchhiking"] = max(err["remove_hitchhiking"], max_abs_err(
                calls["remove_hitchhiking"][0](), calls["remove_hitchhiking"][1]()))
            # the chain floors: the seed whose pole walks the most steps
            # alone; the read whose seed has the most pairs in reach alone
            steps = best_stats["pole_steps"]
            pole = longest_pole(freq, n, starts, sizes, statics, steps)
            window, most_pairs = longest_window(n, starts, sizes, freqs, reps, pp.radius)
            auto_chunks[-1].update(
                best_ms=round(time_ms(calls["estimate_best"][0]), 4),
                best_device_ms=round(device_ms(calls["estimate_best"][0]), 4),
                longest_pole_steps=int(steps.max()),
                longest_pole_rounds=int(steps.max()) // 32 + 1,
                best_floor_ms=round(device_ms(lambda: seedscan.estimate_best(
                    *pole, pp.pb_coverage)), 4),
                hitch_ms=round(time_ms(calls["remove_hitchhiking"][0]), 4),
                hitch_device_ms=round(device_ms(calls["remove_hitchhiking"][0]), 4),
                longest_window_pairs=most_pairs,
                hitch_floor_ms=round(device_ms(lambda: seedscan.remove_hitchhiking(
                    *window, pp.radius, hh)), 4),
                **attr_times)
        torch.cuda.synchronize()
        if ci or name != sets[0][0]:
            continue

        # chunk 0: times, and the least time the card needs for the work;
        # kmer_table_full's traffic from level 1 (the ladder alone) and from
        # each lane's pyramid level
        rows1, queries1, _ = rank_traffic(ix, reads, max_k)
        c, st_c, entries = pyramid_start(wx, reads, max_k)
        rows, queries, loads = rank_traffic(ix, reads, max_k, st_c, c.clamp(min=1))
        ladder_ms = device_ms(lambda: scan.kmer_table_full(ix, reads, lens, max_k))
        nseeds = int(n.sum())
        near_pairs = int(hitch_windows(n, starts, sizes, pp.radius).sum()) // 2
        lane_steps = auto_stats["lane_steps"]
        walk_steps = best_stats["walk_steps"]
        work = {
            # reads + lens in, the two tables out, each touched index row
            # (128 symbols + one checkpoint word) read once; ops: one byte
            # compare per symbol of each query's row
            # the pyramid entries the lanes read, 16 bytes each
            "kmer_table_full": (R * L + 4 * R + K * R * L * 5 + rows * 132 + entries * 16,
                                queries * 128),
            "attributes": (4 * R * L + 16 * R * (L + 1) + 4 * R + 4 * R * L,
                           60 * R * L),
            # attr, prefix, lens, thresholds in; two freq entries and one
            # valid entry per lane-step; the seed records out
            "scan_automaton": (4 * R * L + 16 * R * (L + 1) + 4 * R + 12 * K
                               + 9 * lane_steps + 4 * R + 17 * R * slots,
                               60 * lane_steps),
            # n, starts, sizes, statics in; one freq entry per pole of each
            # seed plus one per walk step; sk, ek, oor out
            "estimate_best": (4 * R + 12 * R * slots
                              + 4 * (2 * nseeds + walk_steps)
                              + 9 * R * slots, 10 * (2 * nseeds + walk_steps)),
            # n and the valid slots' records in, keep out; ten operations
            # per pair of valid slots within the radius (the earlier
            # bound: per pair of valid slots, 10 * sum(n^2))
            "remove_hitchhiking": (4 * R + 13 * nseeds + R * slots, 10 * near_pairs),
        }
        for k, (kern, plain) in calls.items():
            b_ms, b_by = bound(*work[k])
            rec[k] = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                      "bound_ms": b_ms, "bound_by": b_by}
        rec["kmer_table_full"]["device_ms"] = table_chunks[-1]["device_ms"]
        row = auto_chunks[-1]
        for k, pre in (("attributes", "attr"), ("estimate_best", "best"),
                       ("remove_hitchhiking", "hitch")):
            rec[k]["device_ms"] = row[f"{pre}_device_ms"]
        for k, pre in (("attributes", "attr"), ("estimate_best", "best"),
                       ("remove_hitchhiking", "hitch")):
            rec[k]["chain_floor_ms"] = row[f"{pre}_floor_ms"]
        rec["_shape"] = dict(R=R, L=L, K=K, slots=slots, rows=rows, queries=queries,
                             row_loads=loads, pyramid_entries=entries,
                             lanes_by_clean_prefix=hist(c.cpu().numpy()),
                             from_level_1=dict(rows=rows1, queries=queries1,
                                               device_ms_without_pyramid=round(ladder_ms, 4)),
                             lane_steps=lane_steps, walk_steps=walk_steps,
                             seeds=nseeds, pairs_in_reach=near_pairs, chunks={n: sum(c[0] == n for c in chunks)
                                                   for n, _ in sets})
    shape = rec.pop("_shape")
    hand = hand_hitch_chunks(pp.radius, hh, dev)
    err["remove_hitchhiking"] = max([err["remove_hitchhiking"]] + [h["err"] for h in hand])
    for k in SEED_KERNELS:
        rec[k]["max_abs_err"] = err[k]
        rec[k]["equal"] = err[k] == 0
    say("kernels: " + json.dumps([
        {"name": k, "equal": r["equal"], "launches": cuda.LAUNCHES[k],
         "ms": round(r["ms"], 4), "plain_ms": round(r["plain_ms"], 4),
         "bound_ms": round(r["bound_ms"], 5),
         **{x: r[x] for x in ("device_ms", "chain_floor_ms") if x in r}}
        for k, r in rec.items()]) + f" shape {json.dumps(shape)}")
    # the automaton's chain: one block per read, so a launch lasts its
    # longest read's dependent rounds (a window started, or 32 speculative
    # inner iterations); iterations: the plain version's lane-steps
    say("kernels: scan_automaton per chunk (set, chunk, width, seed slots, ms, longest "
        "read's rounds, us per round, seeds, reads with full slots, inner iterations; "
        "estimate_best and remove_hitchhiking event and device ms at those slots, "
        "estimate_best's longest pole in k steps and in load rounds, its chain floor "
        "(device ms of that pole's seed alone); remove_hitchhiking's most pairs in reach "
        "of one seed and its chain floor (device ms of that seed's read alone); "
        "attributes' event and device ms and chain floor (device ms of the longest read "
        "alone)): " + json.dumps(auto_chunks))
    say("kernels: remove_hitchhiking on hand-made chunks (reads, slots, seeds, "
        "max_abs_err, device ms): " + json.dumps(hand))
    rec["scan_automaton"]["chunks"] = auto_chunks
    say("kernels: kmer_table_full per chunk (set, chunk, width, max_abs_err, ms, device "
        "ms; the "
        "walk index's pyramid at ck=" + str(wx.ck) + "): " + json.dumps(table_chunks))
    rec["kmer_table_full"]["chunks"] = table_chunks
    bad = [k for k, r in rec.items() if not r["equal"]]
    check(not bad, f"kernels: {bad} differ from their plain versions")
    check(any(c["full"] for c in auto_chunks
              if c["set"] == "long" and c["slots"] == seedscan.SMAX),
          "kernels: the 7 kb read did not fill the JAX design's 128 seed slots")
    return rec


# ---------------------------------------------------------------------------
# phase 5: the walk kernels against their plain versions
# ---------------------------------------------------------------------------

def tensors_err(got, want) -> float:
    """0 when every tensor (or tensor field) is bit-equal, else the largest
    absolute difference (inf where a NaN or a shape differs)."""
    import dataclasses

    import torch

    if dataclasses.is_dataclass(got):
        return max(tensors_err(getattr(got, f.name), getattr(want, f.name))
                   for f in dataclasses.fields(got))
    if isinstance(got, (tuple, list)):
        return max(tensors_err(g, w) for g, w in zip(got, want))
    if isinstance(got, dict):
        return max(tensors_err(got[k], want[k]) for k in got)
    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    if torch.equal(got, want):
        return 0.0
    d = (got.double() - want.double()).abs()
    return float("inf") if bool(torch.isnan(d).any()) else float(d.max())


def nbytes(obj) -> int:
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return sum(nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))


def time_once(fn):
    """CUDA-event time of one call (the plain versions, run once)."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


LANE_FIELDS = ("longest_lane_steps", "us_per_step", "warps_per_sm", "lane_bytes",
               "smem_per_block")


def lane_fields(kernel, steps, ms):
    """The walk kernels' own numbers: the supersteps of the longest lane
    and the microseconds each took, the warps (gap lanes) resident per SM
    and the shared memory of a lane and of a block, from the last launch."""
    from longreadselfcorrect_tpu_torch.ops import walk

    g = walk.GEOMETRY[kernel]
    return dict(longest_lane_steps=steps, us_per_step=round(ms * 1e3 / steps, 3),
                warps_per_sm=g["warps_per_sm"], lane_bytes=g["lane_bytes"],
                smem_per_block=g["smem_per_block"])


def hist(x) -> dict:
    """{value: count} of an int array."""
    import numpy as np

    v, n = np.unique(np.asarray(x), return_counts=True)
    return {int(a): int(b) for a, b in zip(v, n)}


def phase_walks(corrector, items):
    """Each walk kernel against its plain version on the main path's
    shapes.  Returns {kernel: record}."""
    from dataclasses import replace

    import torch

    from longreadselfcorrect_tpu_torch.ops import rank, walk

    wx, ix, cfg = corrector.wx, corrector.dix, corrector.cfg
    e, cov = corrector.params.error_rate, corrector.params.pb_coverage
    rec = {}
    t_phase = time.perf_counter()

    # every level-up of get_tables (8 -> 9 .. 11 -> 12 on the bench
    # index): each against the plain version, with its index rows, event
    # and device ms and byte bound (rows once, parents read, children
    # written); the record is the last, largest level's
    levels = []
    for k in range(walk.CACHE_K, wx.ck):
        st = tuple(wx.level(k)[:, i].contiguous() for i in range(4))
        got = walk.wcache_level_up(ix, *st, k=k)
        with rank.RowTracker(ix) as rc:
            want, plain_ms = time_once(lambda: walk.wcache_level_up_plain(ix, *st))
        n = st[0].numel()
        lv = dict(level=f"{k}->{k + 1}", parents=n, rows=rc.rows, err=tensors_err(got, want),
                  ms=round(time_ms(lambda: walk.wcache_level_up(ix, *st, k=k)), 4),
                  device_ms=round(device_ms(lambda: walk.wcache_level_up(ix, *st, k=k)), 4),
                  plain_ms=round(plain_ms, 3), bytes=16 * n + 64 * n + rc.rows * 132)
        lv["bound_ms"] = round(bound(lv["bytes"], 0)[0], 5)
        levels.append(lv)
        del got, want
    say("walks: wcache_level_up on every level of get_tables: " + json.dumps(levels)
        + f"; all four {sum(lv['device_ms'] for lv in levels):.4f} device ms, bound "
        f"{sum(lv['bound_ms'] for lv in levels):.5f}")
    top = levels[-1]
    rec["wcache_level_up"] = dict(
        err=max(lv["err"] for lv in levels), ms=top["ms"], plain_ms=top["plain_ms"],
        bytes=top["bytes"], shape=f"{top['parents']} parents -> {4 * top['parents']} "
        f"children, {top['rows']} index rows (level {top['level']})")

    # the gap tasks the 256 noisy reads enumerate, the primary config's
    per_read = [(rid, seq, seeds) for _, chunk, sl in corrector._device_seed_scan(items)
                for (rid, seq), seeds in zip(chunk, sl)]
    tasks, _ = corrector._enumerate_walks(per_read)
    prim = [t for t in tasks if t.init_k >= cfg.CK
            and corrector._task_fits(t.src, t.path, t.trg, t.dis, t.init_k)]
    say(f"walks: {len(per_read)} reads enumerate {len(tasks)} gap tasks, "
        f"{len(prim)} fit the primary config")
    check(len(prim) >= QUEUE_TASKS, f"walks: only {len(prim)} primary tasks")

    # prep of the bank
    query, trg, a, used, kbt, kbr = walk._task_arrays(prim, cfg, len(prim), True)
    up = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
    pargs = (wx, torch.from_numpy(query).cuda(), up["q_len"], torch.from_numpy(trg).cuda(),
             up["n_term"], up["init_k"], up["min_overlap"], cfg, kbt, kbr, True)
    got = walk._prep_kernel(*pargs)
    with rank.RowTracker(ix) as rc:
        want, plain_ms = time_once(lambda: walk.prep_plain(*pargs))
    T = len(prim)
    io = (sum(t.numel() * t.element_size() for t in pargs[1:7])
          + sum(v.numel() * v.element_size() for v in got.values()))
    # the kernel's ladders (csrc/walk.cuh prep_task); the plain version
    # runs every ladder the JAX prep runs
    queries, loads, rows = prep_traffic(wx, pargs)
    rec["walk_prep"] = dict(err=tensors_err(got, want),
                            ms=time_ms(lambda: walk._prep_kernel(*pargs)),
                            plain_ms=plain_ms, bytes=io + rows * 132,
                            shape=f"T={T}, {rows} index rows")
    del got, want
    # the parts of the prep alone, in turns with the whole: the code rows
    # with the tails and constants, the terminal windows' ladders, the
    # chain ring's and the root's; device time (no host time in it)
    parts = {}
    for _ in range(2):
        for pname, bits in (("all", walk.PREP_ALL), ("codes", walk.PREP_CODES),
                            ("terminal", walk.PREP_TERM), ("chain_root", walk.PREP_CHAIN)):
            ms = device_ms(lambda: walk._prep_kernel(*pargs, parts=bits))
            parts[pname] = parts.get(pname, []) + [round(ms, 4)]
    rec["walk_prep"]["device_ms"] = parts["all"][0]
    say(f"walks: walk_prep on the bank (T={T}, kb_term {kbt}, kb_root {kbr}): device ms by "
        f"part "
        f"(two turns) {json.dumps(parts)}; rank queries {queries}, row loads {loads}, "
        f"{rows} index rows (the plain version, every ladder of the JAX prep: "
        f"{rc.queries} queries, {rc.rows} rows); n_term histogram "
        f"{json.dumps(hist(a['n_term']))}; init_k histogram {json.dumps(hist(a['init_k']))}")

    # one superstep, and a walk to completion, of a 512-lane batch
    bcfg = replace(cfg, G=WALK_BATCH)
    consts, state = walk.build_batch(wx, prim[:WALK_BATCH], bcfg, e, cov)
    st_bytes = nbytes(state)
    c_bytes = sum(getattr(consts, f).numel() * getattr(consts, f).element_size()
                  for f in walk.CONST_FIELDS)
    for nsteps, key in ((1, "one"), (MAX_STEPS, "all")):
        clones = [walk.clone(state) for _ in range(REPS + 3)]
        sk = clones.pop()
        rk = walk.walk_steps(wx, consts, sk, bcfg, nsteps)
        sp = clones.pop()
        with rank.RowTracker(ix) as rc:
            rp, plain_ms = time_once(lambda: walk.walk_steps_plain(wx, consts, sp, bcfg, nsteps))
        it = iter(clones)
        ms = time_ms(lambda: walk.walk_steps(wx, consts, next(it), bcfg, nsteps), reps=REPS)
        # the supersteps of the longest lane: its label's growth, and the
        # step that ends it
        steps = min(nsteps, int((sp.cur_len - consts.init_k).max()) + 1)
        rec[f"walk_steps_{key}"] = dict(
            err=max(tensors_err(sk, sp), tensors_err(rk, rp)), ms=ms, plain_ms=plain_ms,
            bytes=c_bytes + 2 * st_bytes + nbytes(rk) + rc.rows * 132,
            shape=f"G={WALK_BATCH}, codes {sorted(set(rk.code.tolist()))}, "
                  f"{rc.rows} index rows",
            **lane_fields("walk_steps", steps, ms))
        del clones, sk, sp
    state = None

    # the queue engine on 1024 tasks of the bank
    qcfg = cfg
    bank = walk.build_bank(wx, prim[:QUEUE_TASKS], qcfg, e, cov)
    got = walk.walk_queue(wx, bank, QUEUE_TASKS, qcfg, MAX_STEPS)
    with rank.RowTracker(ix) as rc:
        want, plain_ms = time_once(lambda: walk.walk_queue_plain(wx, bank, QUEUE_TASKS,
                                                                 qcfg, MAX_STEPS))
    dev = bank.consts.q_len.device
    q_ms = time_ms(lambda: walk.walk_queue(wx, bank, QUEUE_TASKS, qcfg, MAX_STEPS))
    # the supersteps of the longest task: the same tasks walked by walk_steps
    idx = torch.arange(QUEUE_TASKS, device=dev)
    qc, qr = walk._bank_rows(bank, idx)
    qs = walk.init_state(qc, qr, torch.ones(QUEUE_TASKS, dtype=torch.bool, device=dev), qcfg)
    walk.walk_steps(wx, qc, qs, replace(qcfg, G=QUEUE_TASKS), MAX_STEPS)
    q_steps = int((qs.cur_len - qc.init_k).max()) + 1
    del qc, qr, qs
    # bound: the bank in, the reductions out, the index rows; a lane's walk
    # state is neither input nor output of queue_run
    rec["walk_queue"] = dict(
        err=tensors_err(got, want), ms=q_ms, plain_ms=plain_ms,
        bytes=nbytes(bank.consts) + nbytes(bank.root) + nbytes(got) + rc.rows * 132,
        shape=f"T={QUEUE_TASKS}, codes {sorted(set(got.code.tolist()))}, "
              f"{rc.rows} index rows",
        **lane_fields("walk_queue", q_steps, q_ms))
    del bank, got, want
    torch.cuda.synchronize()
    for k, r in rec.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], 0)
    say("walks: " + json.dumps([
        {"name": k, "max_abs_err": r["err"], "ms": round(r["ms"], 4),
         "plain_ms": round(r["plain_ms"], 3), "bound_ms": round(r["bound_ms"], 5),
         "bytes": r["bytes"], "shape": r["shape"],
         **{f: r[f] for f in LANE_FIELDS if f in r}} for k, r in rec.items()])
        + f" in {time.perf_counter() - t_phase:.1f}s")

    checks = ConfigChecks(corrector, prim)
    checks.main_path(tasks)
    bad = [k for k, r in rec.items() if r["err"] != 0]
    check(not bad, f"walks: {bad} differ from their plain versions")
    # walk_steps is reported by its run to completion at G=512
    rec["walk_steps"] = rec["walk_steps_all"]
    for r in rec.values():
        r["max_abs_err"] = r["err"]
    return rec, checks


class ConfigChecks:
    """walk_steps (to completion) and walk_queue held against their plain
    versions on the card at every config the main path launches them at:
    the queue banks (the bulk), the batch-engine buckets at their own
    config and size, the wide (-200) and dense (-300) reruns of flagged
    lanes; an L = max_leaves and a SLAB=False batch and every config of
    the ladder are always among them.
    ``steps`` maps each config (G = 0) to its record."""

    def __init__(self, corrector, pool):
        self.c = corrector
        self.pool = pool       # tasks for configs with none of their own
        self.steps = {}
        self.queue = {}
        self.t = 0.0

    def _flagged(self, work, label, chunk, red, cfg):
        from longreadselfcorrect_tpu_torch.ops import walk

        codes, over = red.code.tolist(), red.overflow.tolist()
        for code, kind, make in ((-200, "wide", walk.wide_config),
                                 (-300, "dense", walk.dense_config)):
            sub = [t for t, c, o in zip(chunk, codes, over) if c == code and not o]
            if sub and not (code == -200 and cfg.L >= cfg.max_leaves):
                work.append((f"{label}/{kind}", sub, make(cfg)))

    def steps_check(self, label, chunk, cfg):
        """walk_steps to completion against walk_steps_plain on chunk at
        cfg (G = len(chunk)).  Returns the kernel's reduction."""
        from dataclasses import replace

        from longreadselfcorrect_tpu_torch.ops import walk

        c = self.c
        t0 = time.perf_counter()
        chunk = chunk[:STEP_CHECK_TASKS]
        check(bool(chunk), f"walks: no task for {label}")
        cfg = replace(cfg, G=len(chunk))
        e, cov = c.params.error_rate, c.params.pb_coverage
        consts, state = walk.build_batch(c.wx, chunk, cfg, e, cov)
        sk = walk.clone(state)
        rk, ms = time_once(lambda: walk.walk_steps(c.wx, consts, sk, cfg, MAX_STEPS))
        rp, plain_ms = time_once(lambda: walk.walk_steps_plain(c.wx, consts, state, cfg,
                                                              MAX_STEPS))
        self.steps[replace(cfg, G=0)] = dict(
            label=label, L=cfg.L, MAXLEN=cfg.MAXLEN, KMAX=cfg.KMAX, SLAB=cfg.SLAB,
            SB=cfg.SB, G=len(chunk), err=max(tensors_err(sk, state), tensors_err(rk, rp)),
            ms=round(ms, 4), plain_ms=round(plain_ms, 3),
            codes=sorted(set(rk.code.tolist())),
            lane_bytes=walk.lane_smem_bytes(cfg).total,
            warps_per_sm=walk.GEOMETRY["walk_steps"]["warps_per_sm"])
        self.t += time.perf_counter() - t0
        return rk

    def main_path(self, tasks, phase="walks"):
        """Route the tasks as _submit_tasks does, run each queue bank on the
        card for its flagged lanes, and check every config reached."""
        from dataclasses import replace

        from longreadselfcorrect_tpu_torch.ops import walk

        c = self.c
        t0 = time.perf_counter()
        e, cov = c.params.error_rate, c.params.pb_coverage
        work, bulk = [], (None, [])
        for engine, cfg, sel in c.buckets(tasks):
            chunk = [tasks[i] for i in sel]
            name = ("bulk" if engine == "queue" else "bucket") + f" KMAX={cfg.KMAX}"
            if engine == "batch":
                work.append((f"{name} MAXLEN={cfg.MAXLEN} SLAB={cfg.SLAB}", chunk, cfg))
                continue
            if len(chunk) > len(bulk[1]):
                bulk = (cfg, chunk)
            bank = walk.build_bank(c.wx, chunk, cfg, e, cov)
            red = walk.walk_queue(c.wx, bank, len(chunk), cfg, MAX_STEPS)
            self._flagged(work, name, chunk, red, cfg)
            key = replace(cfg, G=0)
            if key != replace(c.cfg, G=0) and key not in self.queue:
                # the primary config's queue is checked on 1024 tasks above
                n = min(len(chunk), QUEUE_LO_TASKS)
                got = walk.walk_queue(c.wx, bank, n, cfg, MAX_STEPS)
                want, plain_ms = time_once(lambda: walk.walk_queue_plain(
                    c.wx, bank, n, cfg, MAX_STEPS))
                self.queue[key] = dict(label=name, T=n, err=tensors_err(got, want),
                                       plain_ms=round(plain_ms, 3),
                                       lane_bytes=walk.lane_smem_bytes(cfg).total,
                                       warps_per_sm=walk.GEOMETRY["walk_queue"]["warps_per_sm"])
        self.t += time.perf_counter() - t0
        while work:
            label, chunk, cfg = work.pop(0)
            if replace(cfg, G=0) not in self.steps:
                self._flagged(work, label, chunk, self.steps_check(label, chunk, cfg), cfg)
        # the L = max_leaves and the dense variants of the bulk's config,
        # and the rest of the ladder, whether or not this run's tasks
        # reach them: on the bulk's tasks, and pool tasks that fit
        check(bool(bulk[1]), "walks: no task fits a queue bank")
        for kind, cfg in (("wide", walk.wide_config(bulk[0])),
                          ("dense", walk.dense_config(bulk[0]))):
            if replace(cfg, G=0) not in self.steps:
                self.steps_check(f"bulk KMAX={cfg.KMAX}/{kind} (any lanes)", bulk[1], cfg)
        for cfg in (c.cfg_big, c.cfg_huge, c.cfg_deep, c.cfg_dense):
            if replace(cfg, G=0) not in self.steps:
                self.cover(cfg, f"ladder KMAX={cfg.KMAX} MAXLEN={cfg.MAXLEN} "
                                f"SLAB={cfg.SLAB} (pool tasks)")
        # the narrow-chain bank, whether or not this run's tasks reach it
        if replace(c.cfg_lo, G=0) not in self.queue:
            self.cover_queue(c.cfg_lo, f"narrow-chain bank KMAX={c.cfg_lo.KMAX} (pool tasks)")
        self.report(phase)

    def cover(self, cfg, label="main path only"):
        """Check cfg (G = 0: at most STEP_CHECK_TASKS lanes) on pool tasks
        that fit it."""
        c = self.c
        fit = [t for t in self.pool if t.max_overlap + 1 <= cfg.KMAX
               and c._task_fits(t.src, t.path, t.trg, t.dis, t.init_k, cfg)]
        check(bool(fit), f"walks: no task fits {cfg}")
        self.steps_check(label, fit[: cfg.G or len(fit)], cfg)

    def cover_queue(self, cfg, label):
        """walk_queue at cfg against its plain version on QUEUE_LO_TASKS pool
        tasks that fit it; where too few do, pool tasks whose source seed
        tail is cut to the bank's largest k (init_k = KMAX - 3, the gap a
        seed pair with that best k makes)."""
        from dataclasses import replace

        from longreadselfcorrect_tpu_torch.ops import walk

        c = self.c
        t0 = time.perf_counter()
        e, cov = c.params.error_rate, c.params.pb_coverage
        fits = lambda t: (t.init_k >= cfg.CK and t.max_overlap + 1 <= cfg.KMAX  # noqa: E731
                          and c._task_fits(t.src, t.path, t.trg, t.dis, t.init_k, cfg))
        tasks = [t for t in self.pool if fits(t)][:QUEUE_LO_TASKS]
        native = len(tasks)
        k = cfg.KMAX - 3
        for t in self.pool:
            if len(tasks) >= QUEUE_LO_TASKS:
                break
            if t.init_k > k:
                cut = replace(t, src=t.src[len(t.src) - k:], init_k=k, max_overlap=k + 2)
                if fits(cut):
                    tasks.append(cut)
        check(bool(tasks), f"walks: no task fits {label}")
        bank = walk.build_bank(c.wx, tasks, cfg, e, cov)
        got, ms = time_once(lambda: walk.walk_queue(c.wx, bank, len(tasks), cfg, MAX_STEPS))
        want, plain_ms = time_once(lambda: walk.walk_queue_plain(
            c.wx, bank, len(tasks), cfg, MAX_STEPS))
        self.queue[replace(cfg, G=0)] = dict(
            label=label, T=len(tasks), native=native, err=tensors_err(got, want),
            ms=round(ms, 4), plain_ms=round(plain_ms, 3), codes=sorted(set(got.code.tolist())),
            lane_bytes=walk.lane_smem_bytes(cfg).total,
            warps_per_sm=walk.GEOMETRY["walk_queue"]["warps_per_sm"])
        self.t += time.perf_counter() - t0

    @property
    def err(self):
        return max([r["err"] for r in self.steps.values()]
                   + [r["err"] for r in self.queue.values()])

    def report(self, phase):
        say(f"{phase}: walk_steps to completion per config: "
            + json.dumps(list(self.steps.values()))
            + "; walk_queue per config: " + json.dumps(list(self.queue.values()))
            + f" in {self.t:.1f}s")
        check(self.err == 0, f"{phase}: a config differs from its plain version")


# ---------------------------------------------------------------------------
# phase 6: the seed phase on all noisy reads
# ---------------------------------------------------------------------------

def _sig(s):
    return (s.seed_start_pos, s.seed_len, s.seed_str, s.max_fixed_mer_freq,
            s.is_repeat, s.start_best_kmer_size, s.end_best_kmer_size)


def phase_seeds(corrector, hix, items, long_items):
    """The seed phase on all noisy reads, the first N_HOST_SEEDS held
    against the host search_seeds; then phase 4's long reads, whose seeds
    overflow the JAX design's 128 seed slots, and whose chunk has the slots
    seed_slots sizes from its width, held the same way."""
    import torch

    from longreadselfcorrect_tpu_torch.core import seeds
    from longreadselfcorrect_tpu_torch.core.batch_correct import L_BUCKET
    from longreadselfcorrect_tpu_torch.ops import cuda, seedscan

    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    got = []
    for _, chunk, seeds_lists in corrector._device_seed_scan(items):
        got.extend(seeds_lists)
    dt = time.perf_counter() - t0
    n_seeds = sum(len(s) for s in got)
    for (rid, seq), ss in zip(items[:N_HOST_SEEDS], got):
        want = seeds.search_seeds(seq, hix, corrector.probe_params, corrector.thresh)
        check([_sig(s) for s in ss] == [_sig(s) for s in want],
              f"seeds: read {rid} differs from the host search_seeds")
    say(f"seeds: {len(items)} reads, {n_seeds} seeds in {dt:.3f}s "
        f"({len(items) / dt:.1f} reads/s, host wall incl. collect); launches "
        f"{json.dumps(cuda.LAUNCHES)}; first {N_HOST_SEEDS} reads equal to the "
        f"host search_seeds")
    check(n_seeds > len(items), f"seeds: only {n_seeds} seeds")
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    long_got = [ss for _, _, sl in corrector._device_seed_scan(long_items) for ss in sl]
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    for (rid, seq), ss in zip(long_items, long_got):
        want = seeds.search_seeds(seq, hix, corrector.probe_params, corrector.thresh)
        check([_sig(s) for s in ss] == [_sig(s) for s in want],
              f"seeds: long read {rid} differs from the host search_seeds")
    pp = corrector.probe_params
    width = max(len(seq) for _, seq in long_items)
    slots = seedscan.seed_slots(L_BUCKET * -(-width // L_BUCKET), pp.start_kmer_len,
                                pp.offset)
    past = sum(len(ss) > seedscan.SMAX for ss in long_got)
    per_kb = n_seeds / (sum(len(seq) for _, seq in items) / 1e3)
    say(f"seeds: long reads {[len(seq) for _, seq in long_items]} bp, "
        f"{[len(ss) for ss in long_got]} seeds ({past} past the JAX design's "
        f"{seedscan.SMAX} slots), {slots} slots a read, in {dt:.3f}s (host wall incl. "
        f"collect), launches {json.dumps(launches)}, equal to the host search_seeds; "
        f"the noisy reads' {per_kb:.2f} seeds a kb fill {seedscan.SMAX} slots from "
        f"{seedscan.SMAX / per_kb:.2f} kb on")
    check(past > 0, f"seeds: no long read has more than {seedscan.SMAX} seeds")
    check(launches.get("scan_automaton", 0) > 0,
          "seeds: the long reads' seed scan launched no scan_automaton")
    return got


# ---------------------------------------------------------------------------
# phase 7: the seed phase's two other table routes and their kernels
# ---------------------------------------------------------------------------

def phase_tables(corrector, hix, items, want):
    """The plane route, the wire route and the pool probe, launch counts
    reset just before and read just after; then each table kernel against
    its plain version and against kmer_table_full.  want: phase 6's seeds
    per read.  Returns ({kernel: record}, {kernel: launches})."""
    import numpy as np
    import torch

    from longreadselfcorrect_tpu_torch.core import seeds
    from longreadselfcorrect_tpu_torch.ops import cuda, scan

    pp = corrector.probe_params
    wx, ix, dev = corrector.wx, corrector.dix, corrector.device
    max_k = pp.kmer_len_up_bound + 1
    K, ck, pool = max_k + 1, wx.ck, tuple(pp.pool)
    t_phase = time.perf_counter()
    chunks = [(base, chunk, torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev))
              for base, chunk, mat, lens in corrector._seed_chunks(items)]
    want_sig = [[_sig(s) for s in ss] for ss in want]

    torch.cuda.synchronize()
    cuda.reset_launches()
    # the plane route: the index as plane rows, then the seed phase on the
    # plane table (the composition of tools/prof_seed.py:86-105)
    t0 = time.perf_counter()
    pix = scan.plane_index_of(hix, wx)
    torch.cuda.synchronize()
    t_rows = time.perf_counter() - t0
    t0 = time.perf_counter()
    submitted = [(base, chunk, corrector._seed_records(
        *scan.kmer_table_planes(pix, wx.wcache, reads, lens, max_k, ck), reads, lens))
        for base, chunk, reads, lens in chunks]
    plane = [[_sig(s) for s in ss] for _, _, sl in corrector._seed_collect(submitted)
             for ss in sl]
    t_plane = time.perf_counter() - t0
    # the wire route: the tables on the host, then the host seed scan
    t0 = time.perf_counter()
    f, v, lens_all = corrector._device_seed_tables(items)
    t_wire = time.perf_counter() - t0
    wire = [[_sig(s) for s in seeds.search_seeds(
        seq, hix, pp, corrector.thresh, freq_table=f[:, i, : lens_all[i]],
        valid_table=v[:, i, : lens_all[i]])] for i, (_, seq) in enumerate(items[:N_HOST_SEEDS])]
    # the pool probe, from the walk index's pyramid
    probe = [(scan.kmer_freq_scan(ix, reads, lens, pool, wx),
              scan.kmer_freq_single(ix, reads, lens, pp.scan_kmer_len, wx))
             for _, _, reads, lens in chunks]
    torch.cuda.synchronize()
    launches = {k: cuda.LAUNCHES[k] for k in TABLE_KERNELS}
    check(plane == want_sig, "tables: the plane route's seeds differ from the device seed scan")
    check(wire == want_sig[:N_HOST_SEEDS],
          "tables: search_seeds on the wire tables differs from the device seed scan")
    check(f.shape == (K, len(items), chunks[0][2].shape[1]) and f.dtype == np.int32
          and v.dtype == bool, f"tables: wire tables {f.shape} {f.dtype} {v.dtype}")
    missing = [k for k in TABLE_KERNELS if launches[k] <= 0]
    check(not missing, f"tables: kernels {missing} were not launched on their routes")

    # each kernel against its plain version, and against kmer_table_full
    err = {k: 0 for k in TABLE_KERNELS}
    for fm, pf in ((ix.rbwt, pix.fwd), (ix.bwt, pix.rev)):
        err["plane_rows"] = max(err["plane_rows"], max_abs_err(
            pf.prows, scan.build_plane_rows_plain(fm.blocks, fm.ckpt)))
    cross = []
    rec = {}
    for ci, (_, _, reads, lens) in enumerate(chunks):
        R, L = reads.shape
        calls = {
            "kmer_freq_scan": (lambda: scan.kmer_freq_scan(ix, reads, lens, pool, wx),
                               lambda: scan.kmer_freq_scan_plain(ix, reads, lens, pool)),
            "kmer_table_wire": (lambda: scan.kmer_table_wire(ix, reads, lens, max_k, wx),
                                lambda: scan.kmer_table_wire_plain(ix, reads, lens, max_k)),
            "kmer_table_planes": (
                lambda: scan.kmer_table_planes(pix, wx.wcache, reads, lens, max_k, ck),
                lambda: scan.kmer_table_planes_plain(pix, wx.wcache, reads, lens, max_k, ck)),
        }
        got = {k: kern() for k, (kern, _) in calls.items()}
        want = {k: plain() for k, (_, plain) in calls.items()}
        for k in calls:
            err[k] = max(err[k], max_abs_err(got[k], want[k]))
        # the probe's two calls, and the pool from level 1 (no pyramid)
        err["kmer_freq_scan"] = max(err["kmer_freq_scan"], max_abs_err(
            probe[ci][0], want["kmer_freq_scan"]), max_abs_err(
            probe[ci][1], scan.kmer_freq_scan_plain(ix, reads, lens, (pp.scan_kmer_len,))[0]),
            max_abs_err(scan.kmer_freq_scan(ix, reads, lens, pool), want["kmer_freq_scan"]))
        # the wire table from level 1 (no pyramid)
        err["kmer_table_wire"] = max(err["kmer_table_wire"], max_abs_err(
            scan.kmer_table_wire(ix, reads, lens, max_k), want["kmer_table_wire"]))
        del want
        full_f, full_v = scan.kmer_table_full(ix, reads, lens, max_k)
        f16, vbits = got["kmer_table_wire"]
        pf_, pv_ = got["kmer_table_planes"]
        cross.append(dict(
            pool_rows=torch.equal(got["kmer_freq_scan"], full_f[list(pool)]),
            wire_freq=torch.equal(f16.int(), full_f.clamp(max=32767)),
            wire_valid=bool(np.array_equal(scan.unpack_valid_bits(vbits.cpu().numpy(), K),
                                           full_v.cpu().numpy())),
            planes_rows=torch.equal(pf_[ck:], full_f[ck:]) and torch.equal(pv_[ck:], full_v[ck:]),
            planes_below_ck=bool((pf_[:ck] == -1).all()) and not bool(pv_[:ck].any()),
            clipped=int((full_f > 32767).sum())))
        torch.cuda.synchronize()
        if ci:
            continue

        # chunk 0: times, and the least time the card needs for the work;
        # kmer_freq_scan's and kmer_table_wire's traffic from level 1 (their
        # earlier routes) and from each lane's pyramid level
        rows_pool1, q_pool1, _ = rank_traffic(ix, reads, pool[-1])
        c, st_c, entries = pyramid_start(wx, reads, pool[-1], pool)
        rows_pool, q_pool, loads_pool = rank_traffic(ix, reads, pool[-1], st_c,
                                                     c.clamp(min=1))
        rows_full, q_full, _ = rank_traffic(ix, reads, max_k)
        c, st_c, entries_w = pyramid_start(wx, reads, max_k)
        rows_w, q_w, loads_w = rank_traffic(ix, reads, max_k, st_c, c.clamp(min=1))
        del c, st_c
        codes = scan.plane_codes(reads, ck)
        st = wx.wcache[codes.long()]
        rows_pl, q_pl, _ = rank_traffic(ix, reads, max_k, tuple(st[..., i] for i in range(4)),
                                        ck)
        n_codes = int(torch.unique(codes).numel())
        io = R * L + 4 * R      # reads and lens in
        freq_from_1 = bound(io + 4 * len(pool) * R * L + rows_pool1 * 132, q_pool1 * 128)
        wire_out = 2 * K * R * L + (K + 7) // 8 * R * L   # int16 freq, packed valid
        wire_from_1 = bound(io + wire_out + rows_full * 132, q_full * 128)
        work = {
            # each touched index row (128 symbols + one checkpoint word)
            # read once, each pyramid entry read (16 bytes) once; ops: one
            # byte compare per symbol of a query's row
            "kmer_freq_scan": (io + 4 * len(pool) * R * L + rows_pool * 132 + entries * 16,
                               q_pool * 128),
            "kmer_table_wire": (io + wire_out + rows_w * 132 + entries_w * 16, q_w * 128),
            # 68-byte plane rows, one 16-byte wcache entry per distinct code;
            # ops: 8 word operations per plane word of a query
            "kmer_table_planes": (io + 5 * K * R * L + rows_pl * 68 + n_codes * 16,
                                  q_pl * 4 * 8),
        }
        for k, (kern, plain) in calls.items():
            b_ms, b_by = bound(*work[k])
            rec[k] = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                      "bound_ms": b_ms, "bound_by": b_by}
        rec["kmer_freq_scan"].update(
            device_ms=round(device_ms(calls["kmer_freq_scan"][0]), 4),
            device_ms_without_pyramid=round(device_ms(
                lambda: scan.kmer_freq_scan(ix, reads, lens, pool)), 4),
            single_device_ms=round(device_ms(
                lambda: scan.kmer_freq_single(ix, reads, lens, pp.scan_kmer_len, wx)), 4),
            bound_ms_from_level_1=freq_from_1[0])
        rec["kmer_table_wire"].update(
            device_ms=round(device_ms(calls["kmer_table_wire"][0]), 4),
            device_ms_without_pyramid=round(device_ms(
                lambda: scan.kmer_table_wire(ix, reads, lens, max_k)), 4),
            bound_ms_from_level_1=wire_from_1[0])
        rec["kmer_table_planes"].update(
            device_ms=round(device_ms(calls["kmer_table_planes"][0]), 4))
        shape = dict(R=R, L=L, K=K, ck=ck, pool=pool, chunks=len(chunks),
                     rows=dict(pool=rows_pool, pool_from_level_1=rows_pool1, wire=rows_w,
                               full_from_level_1=rows_full, planes=rows_pl),
                     queries=dict(pool=q_pool, pool_from_level_1=q_pool1, wire=q_w,
                                  full_from_level_1=q_full, planes=q_pl),
                     pool_row_loads=loads_pool, pool_pyramid_entries=entries,
                     wire_row_loads=loads_w, wire_pyramid_entries=entries_w,
                     wcache_entries=n_codes)
        del got
    # plane_rows: one launch per strand, times and bound on the RBWT
    fm = ix.rbwt
    nb = fm.blocks.shape[0]
    b_ms, b_by = bound(nb * (128 + 20 + 4 * scan.PLANE_ROW), nb * 128 * 3)
    rec["plane_rows"] = {"ms": time_ms(lambda: scan.build_plane_rows(fm.blocks, fm.ckpt)),
                         "plain_ms": time_ms(lambda: scan.build_plane_rows_plain(
                             fm.blocks, fm.ckpt)),
                         "bound_ms": b_ms, "bound_by": b_by}
    shape["plane_blocks"] = nb
    for k in TABLE_KERNELS:
        rec[k]["max_abs_err"] = err[k]
    say(f"tables: plane route {len(items)} reads, seeds equal to phase 6's, plane rows "
        f"{t_rows:.3f}s then {t_plane:.3f}s; wire route {len(items)} reads' tables "
        f"{f.shape} in {t_wire:.3f}s, search_seeds on the first {N_HOST_SEEDS} equal to "
        f"phase 6's; launches {json.dumps(launches)}; cross-checks against "
        f"kmer_table_full {json.dumps(cross)}; " + json.dumps([
            {"name": k, "max_abs_err": r["max_abs_err"], "ms": round(r["ms"], 4),
             "plain_ms": round(r["plain_ms"], 3), "bound_ms": round(r["bound_ms"], 5),
             "bound_by": r["bound_by"],
             **{x: r[x] for x in ("device_ms", "device_ms_without_pyramid", "single_device_ms",
                                  "bound_ms_from_level_1") if x in r}}
            for k, r in rec.items()])
        + f" shape {json.dumps(shape)} in {time.perf_counter() - t_phase:.1f}s")
    bad = [k for k in TABLE_KERNELS if err[k] != 0]
    check(not bad, f"tables: {bad} differ from their plain versions")
    off = [i for i, c in enumerate(cross) if not all(
        c[x] for x in ("pool_rows", "wire_freq", "wire_valid", "planes_rows", "planes_below_ck"))]
    check(not off, f"tables: chunks {off} differ from kmer_table_full on shared rows")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 8: pbcorrect end to end
# ---------------------------------------------------------------------------

COUNTERS = ("merge", "corrected_strs", "total_reads_len", "corrected_len",
            "total_seed_num", "total_walk_num", "high_error_num",
            "exceed_depth_num", "exceed_leave_num", "fm_num", "dp_num", "seed_dis")


def run_stream(corrector, items):
    """process_stream over items in pbcorrect's batches; the results."""
    batches = [items[b : b + BATCH_READS] for b in range(0, len(items), BATCH_READS)]
    return [r for part in corrector.process_stream(batches) for r in part]


def stream_line(corrector, results, dt) -> str:
    pt, st = corrector.phase_times, corrector.stats
    total = st["prefetch_hit"] + st["prefetch_miss"] + st["host_fallback"]
    n = len(results)
    t_dp = sum(r.timer_dp for r in results)
    return (f"{n} reads in {dt:.3f}s = {n / dt:.4f} reads/s; split seed "
            f"{pt['seed']:.3f}s walks {pt['walks']:.3f}s replay {pt['replay']:.3f}s; "
            f"gaps {st['gaps']}; gap lookups {total}: {json.dumps(st)}; "
            f"merged {sum(r.merge for r in results)}/{n}, fm_num "
            f"{sum(r.fm_num for r in results)}, DP fallbacks "
            f"{sum(reached_dp(r) for r in results)} (dp_num "
            f"{sum(r.dp_num for r in results)}) taking {t_dp:.3f}s = "
            f"{t_dp / pt['replay'] if pt['replay'] else 0:.1%} of the replay")


def phase_correct(hix, dix, params, items, checks):
    """pbcorrect's path as the CLI takes it on the first run over a pack:
    the walk's interval tables (built anew), then BatchedSelfCorrector's
    process_stream over all noisy reads; launch counts reset just before.
    Every config walk_steps ran at is then held against its plain version
    (if phase 5 did not already).  Returns (launches, WalkIndex, the
    walk_prep records, the banded_fill calls of the pass)."""
    import torch

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import SelfCorrector
    from longreadselfcorrect_tpu_torch.ops import cuda, msa_kernels, walk

    torch.cuda.synchronize()
    cuda.reset_launches()
    walk.STEP_CONFIGS.clear()
    t0 = time.perf_counter()
    wx = walk.WalkIndex.build(dix, hix, walk.walk_ck(hix.bwt.n), reuse=False)
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    corrector = BatchedSelfCorrector(hix, wx, params)
    preps, fills = [], []
    t0 = time.perf_counter()
    with recording(walk, "prep", preps), recording(msa_kernels, "banded_fill", fills):
        results = run_stream(corrector, items)
    dt = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    step_cfgs = dict(walk.STEP_CONFIGS)
    check(len(results) == len(items), f"correct: {len(results)} results")
    host = SelfCorrector(hix, params)
    t1 = time.perf_counter()
    for (rid, seq), res in zip(items[:N_HOST_CHECK], results):
        want = host.process(rid, seq)
        for name in COUNTERS:
            check(getattr(res, name) == getattr(want, name),
                  f"correct: read {rid} {name} differs from the host SelfCorrector")
    t_host = time.perf_counter() - t1
    say(f"correct: tables (ck={wx.ck}, {wx.ck - walk.CACHE_K} level-ups + writing "
        f"wcache{wx.ck}.npy) {t_tables:.3f}s, then the stream: "
        f"{stream_line(corrector, results, dt)}; "
        f"host SelfCorrector {N_HOST_CHECK / t_host:.4f} reads/s on the first "
        f"{N_HOST_CHECK}, all equal; launches {json.dumps(launches)}; walk_steps "
        f"configs {json.dumps([dict(L=k.L, MAXLEN=k.MAXLEN, KMAX=k.KMAX, SLAB=k.SLAB, SB=k.SB, launches=v) for k, v in step_cfgs.items()])}")
    # this path's kernels; the MSA kernels are read on the DP path (phase 9)
    missing = [k for k in SEED_KERNELS + WALK_KERNELS if launches[k] <= 0]
    check(not missing, f"correct: kernels {missing} were not launched on the main path")
    check(len(preps) == launches["walk_prep"], f"correct: {len(preps)} prep calls, "
          f"{launches['walk_prep']} walk_prep launches")
    prep = prep_launches(preps, "correct")
    del preps
    # the pack's level-12 table loaded on a later run: the levels below it
    # extended again (three level-ups)
    hix.__dict__.get("_kmer_caches", {}).clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk.WalkIndex.build(dix, hix, wx.ck)
    torch.cuda.synchronize()
    say(f"correct: tables from the pack's wcache{wx.ck}.npy, the pyramid's levels "
        f"1..{wx.ck - 1} extended again: {time.perf_counter() - t0:.3f}s")
    hix.__dict__["_kmer_caches"][(wx.ck, str(dix.device))] = (wx.pyramid, wx.wcache)
    new = [k for k in step_cfgs if k not in checks.steps]
    for k in new:
        checks.cover(k)
    if new:
        checks.report("correct")
    return launches, wx, prep, fills


# ---------------------------------------------------------------------------
# phase 9: pbcorrect on the 15%-error reads, the DP fallback on the card
# ---------------------------------------------------------------------------

@contextmanager
def recording(mod, name, log):
    """Log the arguments of every call of mod.<name> while active."""
    orig = getattr(mod, name)

    def rec(*args, **kw):
        log.append(args)
        return orig(*args, **kw)

    setattr(mod, name, rec)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def reached_dp(r) -> int:
    """The gaps of a read that went to the MSA/DP fallback (every gap that
    no FM walk closed; dp_num counts those whose MSA succeeded)."""
    return r.total_walk_num - r.fm_num


# the arguments of walk.prep that walk._prep_kernel takes
PREP_ARGS = (0, 1, 2, 3, 5, 6, 8, 16, 17, 18, 19)


def prep_launches(log, phase):
    """walk_prep against prep_plain on every walk.prep call of a pass
    (recorded in log): the tasks, the route (bank: init_k >= CK everywhere,
    the table from CK; else the JAX batch prep's ladders from level 1),
    max_abs_err, device ms (median of 3), rank queries, row loads, index
    rows."""
    from longreadselfcorrect_tpu_torch.ops import walk

    out = []
    for args in log:
        kargs = tuple(args[i] for i in PREP_ARGS)
        err = tensors_err(walk._prep_kernel(*kargs), walk.prep_plain(*kargs))
        q, ld, rows = prep_traffic(kargs[0], kargs)
        out.append(dict(T=int(kargs[1].shape[0]), tasks=int((kargs[5] > 0).sum()),
                        use_wcache=bool(kargs[10]), err=err,
                        device_ms=round(device_ms(lambda: walk._prep_kernel(*kargs), reps=3), 4),
                        queries=q, row_loads=ld, rows=rows))
    say(f"{phase}: walk_prep on each of the pass's {len(out)} prep launches (T, tasks, "
        f"use_wcache, max_abs_err, device ms, rank queries, row loads, index rows): "
        + json.dumps(out))
    check(all(r["err"] == 0 for r in out), f"{phase}: a walk_prep launch differs from "
          "its plain version")
    return out


def phase_dp(hix, wx, params, items, checks):
    """process_stream over the reads at 15% error, launch counts reset just
    before; the gap tasks' configs checked first as phase 5 checks them.
    Returns (launches, calls recorded on the path)."""
    import torch

    from longreadselfcorrect_tpu_torch.core import msa
    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import SelfCorrector
    from longreadselfcorrect_tpu_torch.ops import cuda, msa_kernels, walk

    corrector = BatchedSelfCorrector(hix, wx, params)
    per_read = [(rid, seq, seeds) for _, chunk, sl in corrector._device_seed_scan(items)
                for (rid, seq), seeds in zip(chunk, sl)]
    tasks, _ = corrector._enumerate_walks(per_read)
    checks.pool = checks.pool + [t for t in tasks if t.init_k >= corrector.cfg.CK]
    n_steps, n_queue = len(checks.steps), len(checks.queue)
    checks.main_path(tasks, "dp")
    say(f"dp: {len(items)} reads enumerate {len(tasks)} gap tasks; "
        f"{len(checks.steps) - n_steps} further walk_steps and "
        f"{len(checks.queue) - n_queue} further walk_queue configs checked")

    calls = {"lf": [], "fill": [], "msa": []}
    corrector = BatchedSelfCorrector(hix, wx, params)
    torch.cuda.synchronize()
    cuda.reset_launches()
    walk.STEP_CONFIGS.clear()
    t0 = time.perf_counter()
    preps = []
    with recording(msa_kernels, "lf_extract_groups", calls["lf"]), \
            recording(msa_kernels, "banded_fill", calls["fill"]), \
            recording(msa, "build_multiple_alignment", calls["msa"]), \
            recording(walk, "prep", preps):
        results = run_stream(corrector, items)
    dt = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    step_cfgs = dict(walk.STEP_CONFIGS)
    check(len(results) == len(items), f"dp: {len(results)} results")
    attempts = sum(reached_dp(r) for r in results)
    dp_num = sum(r.dp_num for r in results)
    dp_reads = [(it, r) for it, r in zip(items, results) if reached_dp(r) > 0]
    host = SelfCorrector(hix, params)
    t1 = time.perf_counter()
    for (rid, seq), res in dp_reads[:N_DP_CHECK]:
        want = host.process(rid, seq)
        for name in COUNTERS:
            check(getattr(res, name) == getattr(want, name),
                  f"dp: read {rid} {name} differs from the host SelfCorrector")
    t_host = time.perf_counter() - t1
    say(f"dp: {stream_line(corrector, results, dt)}; {len(dp_reads)} reads reached "
        f"the MSA, {attempts - dp_num} MSA attempts failed; "
        f"{len(calls['msa'])} multiple alignments, {len(calls['lf'])} lf_extract_groups "
        f"calls ({launches['lf_extract']} launches) and {len(calls['fill'])} banded_fill "
        f"calls; host SelfCorrector on the first {min(N_DP_CHECK, len(dp_reads))} DP reads "
        f"{t_host:.1f}s, all equal; launches {json.dumps(launches)}")
    check(bool(dp_reads), "dp: no read reached the DP fallback")
    missing = [k for k in MSA_KERNELS if launches[k] <= 0]
    check(not missing, f"dp: kernels {missing} were not launched on the DP path")
    # one LF launch per multiple alignment (the four extractions grouped)
    check(launches["lf_extract"] == len(calls["lf"]) <= len(calls["msa"]),
          f"dp: {launches['lf_extract']} lf_extract launches for {len(calls['lf'])} "
          f"grouped calls and {len(calls['msa'])} multiple alignments")
    check(len(preps) == launches["walk_prep"], f"dp: {len(preps)} prep calls, "
          f"{launches['walk_prep']} walk_prep launches")
    prep = prep_launches(preps, "dp")
    del preps
    new = [k for k in step_cfgs if k not in checks.steps]
    for k in new:
        checks.cover(k)
    if new:
        checks.report("dp")
    return launches, calls, prep


# ---------------------------------------------------------------------------
# phase 10: the MSA kernels on the DP path's own calls; the gates
# ---------------------------------------------------------------------------

def spread(log, n):
    """Up to n entries of log, evenly spaced, the first and last included."""
    if len(log) <= n:
        return list(log)
    return [log[round(i * (len(log) - 1) / (n - 1))] for i in range(n)]


def wall_ms(fn, reps=3):
    """Median host wall of fn, the device drained before and after."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def crossover(points):
    """The smallest size from which the card wins at every size measured
    (None if the host wins at the largest).  points: (size, host, card)."""
    pts = sorted(points)
    for i, (size, _, _) in enumerate(pts):
        if all(c < h for _, h, c in pts[i:]):
            return size
    return None


def phase_msa(hix, dix, calls, fills8):
    """Each MSA kernel against its plain version on the card, exactly, on
    every call the DP path made (banded_fill also on phase 8's calls,
    fills8), with its device ms; kernel and plain times on the
    median-sized call with its bound; the host route (numpy) against the
    card route (with its copies) per call, which decides the gates of
    core/msa.py; both routes of build_multiple_alignment on DP fallbacks
    of the path.  Returns {kernel: record}."""
    import numpy as np
    import torch

    from longreadselfcorrect_tpu_torch.core import msa
    from longreadselfcorrect_tpu_torch.core.overlapper import fill_cells_batched
    from longreadselfcorrect_tpu_torch.ops import msa_kernels, rank

    rec = {}
    t_phase = time.perf_counter()

    # lf_extract: (index set, [(strand, roots, max_steps)]), one per
    # multiple alignment; each against the grouped plain version
    def lf_inputs(ix, jobs):
        live = [(strand, np.asarray(roots), int(steps)) for strand, roots, steps in jobs
                if len(roots) and steps > 0]
        roots = torch.from_numpy(np.concatenate([r for _, r, _ in live]).astype(np.int32))
        group = torch.from_numpy(np.repeat(np.arange(len(live), dtype=np.int8),
                                           [len(r) for _, r, _ in live]))
        table = [(msa_kernels.STRANDS.index(st), steps) for st, _, steps in live]
        return ix, roots.cuda(), group.cuda(), table, live

    lf = [lf_inputs(*c) for c in calls["lf"]]
    check(bool(lf), "msa: the DP path made no lf_extract call")
    lf.sort(key=lambda c: sum(len(r) * st for _, r, st in c[4]))
    err, gate_pts, chains = 0, [], []
    for ix, roots, group, table, live in lf:
        got = msa_kernels.lf_extract_groups_tensors(ix, roots, group, table)
        err = max(err, max_abs_err(got, msa_kernels.lf_extract_groups_plain(
            ix, roots, group, table)))
        chains.append(int(got[1].max()))
    for ix, roots, group, table, live in spread(lf, MSA_CHECK_GATE):
        jobs = [(st, r, steps) for st, r, steps in live]
        gate_pts.append((sum(len(r) * steps for _, r, steps in live),
                         wall_ms(lambda: [msa._lf_extract(getattr(hix, st), r, steps)
                                          for st, r, steps in jobs]),
                         wall_ms(lambda: msa_kernels.lf_extract_groups(dix, jobs))))
    ix, roots, group, table, live = lf[len(lf) // 2]
    with rank.RowTracker(dix) as rt:
        (_, lens), plain_ms = time_once(lambda: msa_kernels.lf_extract_groups_plain(
            ix, roots, group, table))
    N, S = roots.shape[0], max(st for _, st in table)
    ms = time_ms(lambda: msa_kernels.lf_extract_groups_tensors(ix, roots, group, table))
    # each index row read (symbols + checkpoint row), the roots and groups
    # in, the symbols and lens out; ops: one byte compare per symbol of a
    # step's row.  The chain: the longest row's LF steps, each one load
    # round
    b_ms, b_by = bound(rt.rows * 148 + 5 * N + N * S + 4 * N, int(lens.sum()) * 128)
    chain = int(lens.max())
    rec["lf_extract"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        shape=f"N={N} in {len(table)} groups, steps {[st for _, st in table]}, "
              f"{int(lens.sum())} LF steps, longest row {chain}, {rt.rows} index rows",
        us_per_step=round(ms * 1e3 / max(chain, 1), 3), chain=chain,
        gate=crossover(gate_pts), points=gate_pts)
    say(f"msa: lf_extract on all {len(lf)} grouped calls of the DP path, exact: "
        f"{err == 0}; the median call {ms:.4f} ms = {ms * 1e3 / max(chain, 1):.3f} us per "
        f"dependent step over its longest row's {chain}; longest row per call "
        f"min/median/max {min(chains)}/{statistics.median(chains)}/{max(chains)}")

    # banded_fill: (queries, targets, starts1, starts2, band_width, scores,
    # device), every call of phase 8's pass (8%) and of phase 9's (15%)
    check(bool(calls["fill"]), "msa: the DP path made no banded_fill call")
    err, passes = 0, {}
    for label, log in (("8%", fills8), ("15%", calls["fill"])):
        per_call = []
        for qs, ts, s1, s2, band, scores, _ in log:
            q, t, tl, org, bw = msa_kernels.encode_pairs(qs, ts, s1, s2, band)
            dev = [torch.from_numpy(a).cuda() for a in (q, t, tl, org)]
            err = max(err, max_abs_err(msa_kernels.banded_fill_tensors(*dev, bw, scores),
                                       msa_kernels.banded_fill_plain(*dev, bw, scores)))
            d_ms = device_ms(lambda: msa_kernels.banded_fill_tensors(*dev, bw, scores), reps=3)
            per_call.append(dict(N=q.shape[0], Q=q.shape[1], device_ms=round(d_ms, 4),
                                 us_per_column=round(d_ms * 1e3 / max(q.shape[1], 1), 3)))
        passes[label] = dict(calls=len(log), device_ms=round(sum(c["device_ms"]
                                                                for c in per_call), 4),
                             per_call=per_call)
    fills = sorted(calls["fill"], key=lambda c: len(c[0]) * max(map(len, c[0])))
    gate_pts = []
    for qs, ts, s1, s2, band, scores, device in spread(fills, MSA_GATE_FILL):
        gate_pts.append((len(qs),
                         wall_ms(lambda: fill_cells_batched(qs, ts, s1, s2, band, *scores)),
                         wall_ms(lambda: msa_kernels.banded_fill(qs, ts, s1, s2, band,
                                                                 scores, device))))
    qs, ts, s1, s2, band, scores, device = fills[len(fills) // 2]
    q, t, tl, org, bw = msa_kernels.encode_pairs(qs, ts, s1, s2, band)
    dev = [torch.from_numpy(a).cuda() for a in (q, t, tl, org)]
    _, plain_ms = time_once(lambda: msa_kernels.banded_fill_plain(*dev, bw, scores))
    N, Q = q.shape
    b_ms, b_by = bound(q.size + t.size + 8 * N + 4 * N * (Q + 1) * bw, 12 * N * Q * bw)
    d_ms = device_ms(lambda: msa_kernels.banded_fill_tensors(*dev, bw, scores))
    # the chain floor: Q columns, each at least the column time of one
    # lane at bw = 32 (one slot a thread: the column is its shuffle chain
    # and a few dependent integer ops), measured on 4096 columns
    chain_q = 4096
    one = [torch.from_numpy(a).cuda() for a in msa_kernels.encode_pairs(
        [qs[0][:1] * chain_q], [qs[0][:1] * (chain_q + 32)], [0], [0], 31)[:4]]
    col_us = device_ms(lambda: msa_kernels.banded_fill_tensors(*one, 31, scores)) * 1e3 / chain_q
    # the whole call the DP path makes (encode, upload, kernel, download)
    # and the download of its cells alone
    cells = msa_kernels.banded_fill_tensors(*dev, bw, scores)
    host = torch.empty(cells.shape, dtype=cells.dtype, pin_memory=True)
    rec["banded_fill"] = dict(
        max_abs_err=err, ms=time_ms(lambda: msa_kernels.banded_fill_tensors(*dev, bw, scores)),
        device_ms=round(d_ms, 4), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        shape=f"N={N} Q={Q} T={t.shape[1]} bw={bw}", gate=crossover(gate_pts),
        points=gate_pts, us_per_column=round(d_ms * 1e3 / Q, 3), chain=Q,
        column_floor_us=round(col_us, 4), chain_floor_ms=round(Q * col_us / 1e3, 5),
        call_wall_ms=round(wall_ms(lambda: msa_kernels.banded_fill(
            qs, ts, s1, s2, band, scores, device), reps=5), 4),
        download_ms=round(time_ms(lambda: host.copy_(cells)), 4),
        cells_mb=round(cells.numel() * 4 / 1e6, 3))
    del cells, host
    say(f"msa: banded_fill on every call of the two DP paths, exact: {err == 0}; "
        + json.dumps(passes) + f"; the median call {d_ms:.4f} device ms = "
        f"{d_ms * 1e3 / Q:.3f} us per column over its {Q} columns (chain floor "
        f"{Q * col_us / 1e3:.5f} ms: {col_us:.4f} us a column, one lane at bw 31 over "
        f"{chain_q}); the whole call {rec['banded_fill']['call_wall_ms']} ms wall, the "
        f"download of its {rec['banded_fill']['cells_mb']} MB of cells "
        f"{rec['banded_fill']['download_ms']} ms")

    # both routes of the MSA on DP fallbacks of the path
    routes = []
    for args in spread(calls["msa"], MSA_CHECK_PILEUPS):
        args = args[:7]   # query .. ix
        t0 = time.perf_counter()
        ma_h = msa.build_multiple_alignment(*args)
        t_h = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ma_d = msa.build_multiple_alignment(*args, dev=dix)
        torch.cuda.synchronize()
        t_d = time.perf_counter() - t0
        check(ma_h.num_rows() == ma_d.num_rows()
              and ma_h.calculate_base_consensus(15, -1) == ma_d.calculate_base_consensus(15, -1),
              f"msa: the card's route differs from the host's on a {len(args[0])} bp query")
        routes.append((len(args[0]), ma_h.num_rows(), round(t_h * 1e3, 2), round(t_d * 1e3, 2)))
    lf_sizes = [sum(len(r) * st for _, r, st in c[4]) for c in lf]
    fill_sizes = [len(c[0]) for c in fills]
    say("msa: " + json.dumps([
        {"name": k, "max_abs_err": r["max_abs_err"], "ms": round(r["ms"], 4),
         "plain_ms": round(r["plain_ms"], 3), "bound_ms": round(r["bound_ms"], 5),
         "bound_by": r["bound_by"], "shape": r["shape"]} for k, r in rec.items()])
        + f"; calls: lf_extract {len(lf)} (row-steps min/median/max "
        f"{min(lf_sizes)}/{statistics.median(lf_sizes)}/{max(lf_sizes)}), banded_fill "
        f"{len(fills)} (lanes {min(fill_sizes)}/{statistics.median(fill_sizes)}/"
        f"{max(fill_sizes)})")
    for k, gate_now in (("lf_extract", msa.LF_DEVICE_MIN), ("banded_fill", msa.FILL_DEVICE_MIN)):
        r = rec[k]
        won = sum(c < h for _, h, c in r["points"])
        say(f"msa: gate {k}: host ms vs card ms (copies included) per size "
            f"{json.dumps([(s, round(h, 3), round(c, 3)) for s, h, c in r['points']])}; "
            f"the card wins {won} of {len(r['points'])}; crossover {r['gate']}; "
            f"gate in core/msa.py {gate_now}")
    say(f"msa: build_multiple_alignment host vs card (query bp, rows, host ms, card ms): "
        f"{json.dumps(routes)}; consensus equal; in {time.perf_counter() - t_phase:.1f}s")
    bad = [k for k, r in rec.items() if r["max_abs_err"] != 0]
    check(not bad, f"msa: {bad} differ from their plain versions")
    return rec


def phase_throughput(hix, wx, params, extra):
    """Steady-state throughput: the tables already built, process_stream
    over the further noisy reads, with the DP fallback's LF extraction and
    fills in numpy (msa_dev None, as before they were ported) and on the
    card, in turns host, card, card, host; the four outputs equal."""
    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.ops import cuda

    first = None
    for route in ("host", "card", "card", "host"):
        corrector = BatchedSelfCorrector(hix, wx, params)
        if route == "host":
            corrector.msa_dev = None
        cuda.reset_launches()
        t0 = time.perf_counter()
        results = run_stream(corrector, extra)
        dt = time.perf_counter() - t0
        check(len(results) == len(extra), f"throughput: {len(results)} results")
        if first is None:
            first = results
        for a, b in zip(first, results):
            for name in COUNTERS:
                check(getattr(a, name) == getattr(b, name),
                      f"throughput: read {a.read_id} {name} differs between DP routes")
        say(f"throughput: DP route {route}, tables warm, "
            f"{stream_line(corrector, results, dt)}; seed kernel launches "
            + json.dumps({k: cuda.LAUNCHES[k] for k in SEED_KERNELS}))
    return first


def correct_fa(items, results) -> str:
    """The correct.fa pbcorrect writes for these results."""
    return "".join(f">{rid}\n{s}\n" for (rid, _), r in zip(items, results) if r.merge
                   for s in r.corrected_strs)


# ---------------------------------------------------------------------------
# phase 13: the repaired edge cases on the card
# ---------------------------------------------------------------------------

N_EDGE_HOST = 4       # lowercased reads held against the host SelfCorrector


def phase_edge(hix, wx, params, items):
    """Lowercased reads, all-empty batches and 15-52 bp reads through
    process_stream, launch counts reset just before; each held against the
    host SelfCorrector."""
    import numpy as np
    import torch

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import SelfCorrector
    from longreadselfcorrect_tpu_torch.ops import cuda

    first = items[:BATCH_READS]
    lower = [(rid, seq.lower() if i % 2 else seq) for i, (rid, seq) in enumerate(first)]
    empty = [(f"e{i}", "") for i in range(BATCH_READS)]
    genome = make_genome(np.random.default_rng(2026))
    rng = np.random.default_rng(2031)
    short = []
    for i in range(BATCH_READS):
        p = int(rng.integers(0, GENOME_LEN - 200))
        short.append((f"t{i}", noisify(rng, genome[p : p + 200], 0.08)[: 15 + i % 38]))
    check(all(len(s) == 15 + i % 38 for i, (_, s) in enumerate(short)), "edge: read lengths")
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    runs = {}
    for name, batches in (("upper", [first]), ("lower", [lower]),
                          ("empty_last", [first, empty]), ("empty_only", [empty]),
                          ("short", [short])):
        corrector = BatchedSelfCorrector(hix, wx, params)
        runs[name] = ([r for part in corrector.process_stream(batches) for r in part],
                      dict(corrector.stats))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)

    def same(a, b, what):
        check(len(a) == len(b), f"edge: {what}: {len(a)} results, {len(b)} expected")
        for x, y in zip(a, b):
            for name in COUNTERS:
                check(getattr(x, name) == getattr(y, name),
                      f"edge: {what}: read {x.read_id} {name} differs")

    (up, st_up), (lo, st_lo) = runs["upper"], runs["lower"]
    same(lo, up, "lowercased vs upper case")
    for k in ("prefetch_hit", "prefetch_miss", "host_fallback"):
        check(st_lo[k] == st_up[k], f"edge: lowercased reads {k} {st_lo[k]}, upper {st_up[k]}")
    host = SelfCorrector(hix, params)
    t1 = time.perf_counter()
    same(lo[:N_EDGE_HOST], [host.process(rid, seq) for rid, seq in lower[:N_EDGE_HOST]],
         "lowercased vs host")
    t_lower = time.perf_counter() - t1
    host_empty = [host.process(rid, seq) for rid, seq in empty]
    same(runs["empty_last"][0], up + host_empty, "last batch empty")
    same(runs["empty_only"][0], host_empty, "only batch empty")
    check(not any(r.merge for r in host_empty), "edge: an empty read was merged")
    t1 = time.perf_counter()
    same(runs["short"][0], [host.process(rid, seq) for rid, seq in short], "15-52 bp vs host")
    t_short = time.perf_counter() - t1
    missing = [k for k in SEED_KERNELS + ("walk_prep",) if launches[k] <= 0]
    check(not missing, f"edge: kernels {missing} were not launched")
    n_lower = sum(c.islower() for _, s in lower for c in s)
    say(f"edge: {len(lower)} reads, {n_lower} lowercase symbols in every other read: "
        f"results and lookups equal to upper case ({json.dumps(st_lo)}), the first "
        f"{N_EDGE_HOST} equal to the host SelfCorrector ({t_lower:.1f}s); a stream of "
        f"{len(first)} reads then {len(empty)} empty records and one of the empty records "
        f"alone: equal to the host, none merged; {len(short)} reads of 15-52 bp "
        f"({sum(r.total_seed_num > 0 for r in runs['short'][0])} with seeds, "
        f"{sum(r.merge for r in runs['short'][0])} merged) equal to the host "
        f"({t_short:.1f}s); the five streams {dt:.2f}s; launches {json.dumps(launches)}")


# ---------------------------------------------------------------------------
# phase 14: pbcorrect as N processes sharing the card
# ---------------------------------------------------------------------------

# one pbcorrect rank: the CLI, then its peak device memory and launches
RANK_MAIN = (
    "import json, sys\n"
    "import torch\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from longreadselfcorrect_tpu_torch import cli\n"
    "from longreadselfcorrect_tpu_torch.ops import cuda\n"
    "rc = cli.main(sys.argv[2:])\n"
    "print('RANK ' + json.dumps({'peak_bytes': torch.cuda.max_memory_allocated(), "
    "'launches': cuda.LAUNCHES}), file=sys.stderr, flush=True)\n"
    "sys.exit(rc)\n")
PROCESSES = (1, 2, 4)


def summary_lines(stdout: str) -> list:
    """pbcorrect's summary without its three per-phase timer lines."""
    return [line for line in stdout.splitlines()
            if line and not line.startswith("Time of searching")]


def run_ranks(cmds, timeout):
    """Start every command at once; [(returncode, stdout, stderr)], every
    process stopped before returning."""
    procs = [subprocess.Popen(c, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def phase_multiproc(reads_fa, prefix, want_correct):
    """pbcorrect over reads_fa as N processes on the card, for each N of
    PROCESSES; outputs equal across N and to want_correct."""
    from longreadselfcorrect_tpu_torch.entry import free_port

    first = None
    per_n = []
    for n in PROCESSES:
        out = os.path.join(CACHE, f"multiproc{n}")
        if os.path.isdir(out):
            for f in os.listdir(out):
                os.remove(os.path.join(out, f))
        argv = ["pbcorrect", reads_fa, "-p", prefix, "-o", out, "-c", str(COVERAGE),
                "-g", "10", "--engine", "device", "--device", "cuda"]
        port = free_port()
        cmds = [[sys.executable, "-c", RANK_MAIN, REPO] + argv
                + (["--num-processes", str(n), "--process-id", str(r),
                    "--coordinator", f"127.0.0.1:{port}"] if n > 1 else [])
                for r in range(n)]
        t0 = time.perf_counter()
        ranks = run_ranks(cmds, 900)
        wall = time.perf_counter() - t0
        rows = []
        for r, (rc, stdout, stderr) in enumerate(ranks):
            check(rc == 0, f"multiproc: N={n} rank {r} exited with {rc}:\n{stderr[-3000:]}")
            done = re.findall(r"Processed (\d+) sequences in ([\d.]+)s", stderr)
            check(bool(done), f"multiproc: N={n} rank {r} printed no progress line")
            info = json.loads(stderr.rsplit("RANK ", 1)[1].splitlines()[0])
            k, t = int(done[-1][0]), float(done[-1][1])
            win = re.findall(r"Stream of (\d+) sequences from ([\d.]+) to ([\d.]+)", stderr)
            check(len(win) == 1, f"multiproc: N={n} rank {r} printed no stream window")
            rows.append(dict(rank=r, reads=k, s=t, reads_per_s=round(k / t, 2),
                             stream_reads=int(win[0][0]), start=float(win[0][1]),
                             end=float(win[0][2]),
                             peak_mb=round(info["peak_bytes"] / 1e6, 1),
                             launches={x: info["launches"][x] for x in SEED_KERNELS
                                       + WALK_KERNELS + MSA_KERNELS}))
        # walk_steps runs only where a gap needs a batch bucket or a rerun,
        # so each kernel must have run in some rank of the N
        missing = [k for k in SEED_KERNELS + WALK_KERNELS
                   if not any(x["launches"][k] for x in rows)]
        check(not missing, f"multiproc: N={n}: no rank launched {missing}")
        with open(os.path.join(out, "correct.fa")) as f1, \
                open(os.path.join(out, "discard.fa")) as f2:
            files = (f1.read(), f2.read())
        got = (files, summary_lines(ranks[0][1]))
        check(got[1] != [], f"multiproc: N={n} printed no summary")
        check(all(not o for _, o, _ in ranks[1:]), f"multiproc: N={n} a rank > 0 printed")
        if first is None:
            first = got
            check(files[0] == want_correct,
                  "multiproc: correct.fa differs from phase 12's stream")
        check(got == first, f"multiproc: N={n} output differs from N={PROCESSES[0]}")
        # the ranks' stream windows on one clock: all reads over the span
        # from the first start to the last end, and the time every rank
        # was streaming at once
        t_first = min(x["start"] for x in rows)
        span = max(x["end"] for x in rows) - t_first
        overlap = max(0.0, min(x["end"] for x in rows) - max(x["start"] for x in rows))
        for x in rows:
            x["start"], x["end"] = round(x["start"] - t_first, 3), round(x["end"] - t_first, 3)
        per_n.append(dict(N=n, wall_s=round(wall, 2),
                          sum_reads_per_s=round(sum(x["reads_per_s"] for x in rows), 2),
                          span_reads_per_s=round(sum(x["stream_reads"] for x in rows) / span, 2),
                          span_s=round(span, 3), overlap_s=round(overlap, 3),
                          overlap_share=round(overlap / span, 3), ranks=rows))
        say(f"multiproc: N={n} processes on one card: wall {wall:.2f}s, stream reads/s per "
            f"rank (last progress line) and their sum, all reads over the span of the "
            f"ranks' stream windows (first start to last end, s from the first start), "
            f"the time all N streamed at once {json.dumps(per_n[-1])}")
    say(f"multiproc: correct.fa ({first[0][0].count('>')} reads), discard.fa "
        f"({first[0][1].count('>')} reads) and the summary equal for N = "
        f"{', '.join(map(str, PROCESSES))} and to phase 12; os.cpu_count() "
        f"{os.cpu_count()}; summary {json.dumps(first[1])}")
    return per_n


# ---------------------------------------------------------------------------
# phase 15: the multi-GPU path (NCCL)
# ---------------------------------------------------------------------------

def in_process_shards(wx, pool, bcfg, e, cov):
    """The ranks' shards of a walk batch walked one after another on this
    card (mesh.shard_lanes at world sizes 2 and 4, as shard_walk_batch
    splits them), their Reduced fields concatenated and cut to G: equal to
    the unsharded walk_steps bit for bit, at G = WALK_BATCH and at a G
    that leaves padding lanes.  Returns [{G, world, pad lanes}]."""
    from dataclasses import replace

    import torch

    from longreadselfcorrect_tpu_torch.ops import walk
    from longreadselfcorrect_tpu_torch.parallel import mesh

    out = []
    for G in (WALK_BATCH, WALK_BATCH - 3):
        gcfg = replace(bcfg, G=G)
        consts, state = walk.build_batch(wx, pool[:G], gcfg, e, cov)
        ref = walk.walk_steps(wx, consts, walk.clone(state), gcfg, MAX_STEPS)
        for world in (2, 4):
            parts = []
            for r in range(world):
                c, s = mesh.shard_lanes(consts, walk.clone(state), world, r)
                parts.append(walk.walk_steps(wx, c, s, replace(gcfg, G=s.code.shape[0]),
                                             MAX_STEPS))
            got = walk.Reduced(**{f: torch.cat([getattr(p, f) for p in parts])[:G]
                                  for f in walk.REDUCED_FIELDS})
            err = tensors_err(got, ref)
            check(err == 0, f"multigpu: G={G} in {world} shards differs from the "
                  f"unsharded walk ({err})")
            out.append(dict(G=G, world=world, pad=-G % world))
    return out


def global_counter_sum_on_card(distributed, counters):
    """distributed.global_counter_sum(counters) with its default device,
    and the device type of every tensor it all-reduced."""
    import torch

    seen, real = [], torch.distributed.all_reduce

    def spy(t, *a, **k):
        seen.append(t.device.type)
        return real(t, *a, **k)

    torch.distributed.all_reduce = spy
    try:
        return distributed.global_counter_sum(counters), seen
    finally:
        torch.distributed.all_reduce = real


def phase_multigpu(wx, corrector, pool):
    """entry.dryrun_multigpu over every card, launch counts reset just
    before; then phase 5's 512-lane batch sharded over the process group
    against the unsharded walk, every rank's shard at world sizes 2 and 4
    walked in this process (in_process_shards), a 13-float
    all_reduce's device time, and global_counter_sum reducing on the card
    by default.
    Returns the all_reduce's device ms."""
    from dataclasses import replace

    import numpy as np
    import torch

    from longreadselfcorrect_tpu_torch import entry
    from longreadselfcorrect_tpu_torch.ops import cuda, walk
    from longreadselfcorrect_tpu_torch.parallel import distributed, mesh

    n = torch.cuda.device_count()
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    dry = entry.dryrun_multigpu(n)
    t_dry = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    if n == 1:
        missing = [k for k in ("walk_prep", "walk_steps") if launches[k] <= 0]
        check(not missing, f"multigpu: the dry run launched no {missing}")
    distributed.init(f"127.0.0.1:{entry.free_port()}", 1, 0)
    try:
        dev = distributed.rank_device(0, "cuda")
        group = mesh.make_group(dev)
        e, cov = corrector.params.error_rate, corrector.params.pb_coverage
        bcfg = replace(corrector.cfg, G=WALK_BATCH)
        consts, state = walk.build_batch(wx, pool[:WALK_BATCH], bcfg, e, cov)
        ref = walk.walk_steps(wx, consts, walk.clone(state), bcfg, MAX_STEPS)
        sh = mesh.sharded_multistep(wx, *mesh.shard_walk_batch(group, consts, state),
                                    bcfg, MAX_STEPS, group, WALK_BATCH)
        err = tensors_err(sh, ref)
        check(err == 0, f"multigpu: the sharded walk differs from the unsharded ({err})")
        shards = in_process_shards(wx, pool, bcfg, e, cov)
        x = torch.ones(13, dtype=torch.float32, device=dev)
        ar_dev = device_ms(lambda: torch.distributed.all_reduce(x, group=group))
        ar_ev = time_ms(lambda: torch.distributed.all_reduce(x, group=group))
        total = mesh.all_reduce_counters(group, torch.ones((1, 13), device=dev))
        check(bool((total == 1).all()), "multigpu: the counter all-reduce is not the sum")
        counters = np.arange(13, dtype=np.float64) * 1.5 + 2.0 ** 40
        summed, on = global_counter_sum_on_card(distributed, counters)
        check(on == ["cuda"] and np.array_equal(summed, counters),
              f"multigpu: global_counter_sum reduced on {on}, or is not the sum")
        backend = torch.distributed.get_backend(group)
    finally:
        distributed.shutdown()
    say(f"multigpu: dryrun_multigpu({n}) {json.dumps(dry)} in {t_dry:.2f}s, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; {backend} group of 1: "
        f"sharded_multistep on the {WALK_BATCH}-lane batch equal to walk_steps (codes "
        f"{sorted(set(ref.code.tolist()))}); every rank's shard walked in this process "
        f"{json.dumps(shards)}; all_reduce of 13 floats {ar_dev:.4f} device ms, "
        f"{ar_ev:.4f} event ms; global_counter_sum on the card equal to its input")
    return ar_dev


# ---------------------------------------------------------------------------
# phase 16: host subcommands (the PacBio hybrid pipeline and the utilities)
# ---------------------------------------------------------------------------

# tests/test_hybrid.py's corpus recipe (rng seed 321): 60x of 100 bp short
# reads and 5x of 1 kb long reads at 15% substitution error, on a genome cut
# from 30 to 5 kb (at 30 kb the JAX CLI takes ~7 min on a CPU core for the
# pipeline: correct 139 s, pbhc 104 s, fmwalk 64 s, overlap 66 s)
HOST_SEED = 321
HOST_GENOME_LEN = 5_000
HOST_SR, HOST_SR_LEN = 3_000, 100
HOST_PB, HOST_PB_LEN, HOST_PB_ERR = 25, 1000, 0.15
# read pairs for `all` (rng seed 322): 30 pairs, 300 bp inserts, over the
# genome's first 900 bp (its fmwalk takes ~1.2 s a pair on a CPU core)
HOST_PAIRS, HOST_INSERT, HOST_PAIR_SPAN = 30, 300, 900
HOST_BARCODED = 16                     # barcoded 1 kb reads for kmercheck (seed 323)
HOST_ASM_SHARE = 0.9                   # asmlong's longest contig covers this share
# the files `index` writes on both of its routes (fmbuild and numpy)
INDEX_FILES = (".bwt.npz", ".rbwt.npz", ".lex", ".rlex", ".ssa", ".rssa")
STDOUT = "<stdout>"


def barcoded_reads(genome, rng, n, length, err):
    """n reads of the genome with planted insertions and deletions, and
    their barcode records (core/bcode.py's format: per read base one hex
    pair, the upper digit counting an inserted base, the lower the flags
    of the genome bases deleted after it)."""
    base_hex = {"A": 1, "T": 2, "C": 4, "G": 8}
    reads, records = [], []
    for i in range(n):
        p = int(rng.integers(0, len(genome) - length))
        chars, upper, lower = [], [], []
        for ch in genome[p : p + length]:
            r = rng.random()
            if r < err / 2 and chars:
                lower[-1] |= base_hex[ch]          # ch deleted after the last base
                continue
            chars.append(ch)
            upper.append(0)
            lower.append(0)
            if r < err:
                chars.append("ACGT"[int(rng.integers(0, 4))])   # an inserted base
                upper.append(1)
                lower.append(0)
        rid, seq = f"b{i}", "".join(chars)
        code = "".join(f"{u:x}{d:x}" for u, d in zip(upper, lower))
        reads.append((rid, seq))
        records.append(f"{rid} 0 {len(seq) - 1} genome {p} {p + length} {code} False 1")
    return reads, records


def make_host_corpus(d: str) -> str:
    """Phase 16's inputs under d; returns the genome."""
    import numpy as np

    from longreadselfcorrect_tpu_torch.core.alphabet import revcomp_str as revcomp

    rng = np.random.default_rng(HOST_SEED)
    genome = "".join(rng.choice(list("ACGT"), size=HOST_GENOME_LEN))
    with open(os.path.join(d, "sr.fa"), "w") as f:
        for i in range(HOST_SR):
            p = int(rng.integers(0, HOST_GENOME_LEN - HOST_SR_LEN))
            r = genome[p : p + HOST_SR_LEN]
            f.write(f">s{i}\n{revcomp(r) if i % 2 else r}\n")
    with open(os.path.join(d, "pb.fa"), "w") as f:
        for i in range(HOST_PB):
            p = int(rng.integers(0, HOST_GENOME_LEN - HOST_PB_LEN))
            r = list(genome[p : p + HOST_PB_LEN])
            for j in range(len(r)):
                if rng.random() < HOST_PB_ERR:
                    r[j] = "ACGT"[int(rng.integers(0, 4))]
            f.write(f">pb{i}\n{''.join(r)}\n")
    rng = np.random.default_rng(HOST_SEED + 1)
    with open(os.path.join(d, "pe_1.fa"), "w") as f1, \
            open(os.path.join(d, "pe_2.fa"), "w") as f2:
        for i in range(HOST_PAIRS):
            p = int(rng.integers(0, HOST_PAIR_SPAN - HOST_INSERT))
            frag = genome[p : p + HOST_INSERT]
            f1.write(f">p{i}/1\n{frag[:HOST_SR_LEN]}\n")
            f2.write(f">p{i}/2\n{revcomp(frag[-HOST_SR_LEN:])}\n")
    reads, records = barcoded_reads(genome, np.random.default_rng(HOST_SEED + 2),
                                    HOST_BARCODED, 1000, 0.04)
    with open(os.path.join(d, "kc.fa"), "w") as f:
        f.writelines(f">{rid}\n{seq}\n" for rid, seq in reads)
    with open(os.path.join(d, "kc.bcode"), "w") as f:
        f.write("\n".join(records) + "\n")
    with open(os.path.join(d, "grep.txt"), "w") as f:
        f.write(" ".join([genome[p : p + 25] for p in (100, 2_500, 4_900)]
                         + ["ACGT" * 8]) + "\n")
    with open(os.path.join(d, "kmerfreq.txt"), "w") as f:
        f.write(f"{genome[1000:1060]} 21 1\n{revcomp(genome[3000:3080])} 31 0\n")
    return genome


def host_stages():
    """Phase 16's stages in order: (subcommand, argv, stdin file, output
    files).  The PacBio hybrid pipeline (SURVEY.md: preprocess -> index ->
    correct -> index -> pbhc -> index -> fmwalk validate -> filter ->
    overlap -> asmlong; filter and overlap each read the index of their
    own input), then the other subcommands on its outputs.  An argv item
    that is a one-tuple names a FASTA file whose first read's id goes
    there."""
    def idx(p):
        return [p + s for s in INDEX_FILES]

    asqg = "pb.pass.asqg.gz"
    return [
        ("preprocess", ["preprocess", "--no-quality", "-o", "sr.pp.fa", "sr.fa"],
         None, ["sr.pp.fa"]),
        ("index", ["index", "sr.pp.fa"], None, idx("sr.pp")),
        ("correct", ["correct", "-p", "sr.pp", "-o", "sr.ec.fa", "-k", "31", "-x", "3",
                     "--discard", "sr.ec.discard.fa", "sr.pp.fa"],
         None, ["sr.ec.fa", "sr.ec.discard.fa"]),
        ("index", ["index", "sr.ec.fa"], None, idx("sr.ec")),
        ("index", ["index", "pb.fa"], None, idx("pb")),
        ("pbhc", ["pbhc", "pb.fa", "-p", "sr.ec", "-f", "pb", "-o", "pb.ec.fa",
                  "-r", "100", "-c", "60"],
         None, ["pb.ec.fa", "pb.ec.discard.fa", STDOUT]),
        ("index", ["index", "pb.ec.fa"], None, idx("pb.ec")),
        ("fmwalk", ["fmwalk", "-a", "validate", "-p", "sr.ec", "-m", "31",
                    "--discard", "", "-o", "pb.valid.fa", "pb.ec.fa"],
         None, ["pb.valid.fa"]),
        ("index", ["index", "pb.valid.fa"], None, idx("pb.valid")),
        ("filter", ["filter", "-p", "pb.valid", "--no-kmer-check", "-o", "pb.pass.fa",
                    "pb.valid.fa"], None, ["pb.pass.fa", "pb.pass.fa.discard.fa"]),
        ("index", ["index", "pb.pass.fa"], None, idx("pb.pass")),
        ("overlap", ["overlap", "-p", "pb.pass", "-m", "100", "--exact", "-o", asqg,
                     "pb.pass.fa"], None, [asqg]),
        ("asmlong", ["asmlong", asqg, "-i", "400", "-m", "100", "-o", "asm"],
         None, ["asm-contigs.fa", "asm-graph.asqg.gz", "StriDe-graph.dot"]),
        ("assemble", ["assemble", asqg, "-p", "pb.pass", "-m", "100", "-r", "1000",
                      "-i", "400", "--no-pe", "-o", "sasm"], None, ["sasm-contigs.fa"]),
        ("merge", ["merge", "pb.pass.fa", "-p", "pb.pass", "-m", "100", "-o",
                   "pb.merged.fa"], None, ["pb.merged.fa"]),
        ("oview", ["oview", asqg], None, [STDOUT]),
        ("subgraph", ["subgraph", ("pb.pass.fa",), asqg, "-s", "2", "-o", "sub.asqg.gz"],
         None, ["sub.asqg.gz", "sub.asqg.gz.dot"]),
        ("grep", ["grep", "sr.ec.fa", "-p", "sr.ec"], "grep.txt", [STDOUT]),
        ("kmerfreq", ["kmerfreq", "-p", "sr.ec", "-c", "60"], "kmerfreq.txt", [STDOUT]),
        ("kmercheck", ["kmercheck", "kc.fa", "-p", "sr.ec", "-o", "kc", "-b", "kc.bcode",
                       "-c", "60"], None, ["kc/total.box", "kc/value.box"]),
        ("all", ["all", "pe_1.fa", "pe_2.fa", "-r", "100", "-i", str(HOST_INSERT),
                 "-d", "all"], None,
         ["all/reads.fa", "all/READ.ECOLr.fasta", "all/merged.fa",
          "all/merged.filter.pass.fa", "all/merged.filter.pass.asqg.gz",
          "all/StriDe-contigs.fa"]),
    ]


def output_bytes(d: str, name: str) -> bytes:
    """A stage output's content, decompressed for .gz (a gzip header holds
    the time it was written), with the run directory's absolute path
    written as <dir> (`all` names its ASQG's input file by it)."""
    import gzip

    path = os.path.join(d, name)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read().replace(os.path.abspath(d).encode(), b"<dir>")


def stage_digest(d: str, outputs, stdout: str) -> str:
    """One SHA-256 over the digests of a stage's outputs, in order."""
    import hashlib

    h = hashlib.sha256()
    for name in outputs:
        data = stdout.encode() if name == STDOUT else output_bytes(d, name)
        h.update(f"{name} {hashlib.sha256(data).hexdigest()}\n".encode())
    return h.hexdigest()


def run_host_stage(module: str, d: str, stage, env=None):
    """One stage as `python -m module ...` in d with PYTHONHASHSEED=0 (and
    env's variables): (argv, returncode, stdout, stderr, wall seconds)."""
    from longreadselfcorrect_tpu_torch.io import fasta

    _, argv, stdin, _ = stage
    argv = [next(fasta.read_seqs(os.path.join(d, a[0]))).id if isinstance(a, tuple) else a
            for a in argv]
    env = {**os.environ, "PYTHONHASHSEED": "0", **(env or {})}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    fin = open(os.path.join(d, stdin)) if stdin else subprocess.DEVNULL
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, "-m", module] + argv, cwd=d, env=env,
                           stdin=fin, capture_output=True, text=True, timeout=600)
    finally:
        if stdin:
            fin.close()
    return argv, p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def run_host_pipeline(module: str, d: str, env=None):
    """Make the corpus in d and run every stage of host_stages through
    module's CLI: (genome, [(label, argv, rc, stdout, stderr, seconds,
    digest)] in stage order).  `all`, which reads only its own inputs, runs
    beside the other stages; a failing stage ends the chain it is in."""
    import threading

    os.makedirs(d, exist_ok=True)
    genome = make_host_corpus(d)
    stages = list(enumerate(host_stages()))
    chains = [[s for s in stages if s[1][0] == "all"], [s for s in stages if s[1][0] != "all"]]
    done = {}

    def run(chain):
        for i, stage in chain:
            argv, rc, so, se, dt = run_host_stage(module, d, stage, env)
            dig = stage_digest(d, stage[3], so) if rc == 0 else None
            done[i] = (f"{i:02d} {stage[0]}", argv, rc, so, se, dt, dig)
            if rc != 0:
                return

    side = threading.Thread(target=run, args=(chains[0],))
    side.start()
    try:
        run(chains[1])
    finally:
        side.join()
    return genome, [done[i] for i in sorted(done)]


def host_checks(genome: str, d: str) -> dict:
    """What tests/test_hybrid.py and tests/test_assembly.py check, on
    phase 16's outputs: the pbhc pieces are genome substrings (either
    strand), and asmlong's longest contig is one and covers
    HOST_ASM_SHARE of the genome."""
    from longreadselfcorrect_tpu_torch.core.alphabet import revcomp_str as revcomp
    from longreadselfcorrect_tpu_torch.io import fasta

    pieces = [r.seq for r in fasta.read_seqs(os.path.join(d, "pb.ec.fa"))]
    good = sum(s in genome or revcomp(s) in genome for s in pieces)
    contigs = [r.seq for r in fasta.read_seqs(os.path.join(d, "asm-contigs.fa"))]
    longest = max(contigs, key=len, default="")
    return {"pieces": len(pieces), "pieces_in_genome": good,
            "contigs": len(contigs), "longest": len(longest),
            "longest_in_genome": longest in genome or revcomp(longest) in genome}


# SHA-256 of each stage's outputs (stage_digest), from the JAX CLI on the
# CPU (python -m longreadselfcorrect_tpu.cli, same corpus, PYTHONHASHSEED=0,
# no native/hashorder.so); tests/test_torch_cli_host.py holds these against
# a fresh run of the JAX CLI and of the port's
HOST_DIGESTS = {
    "00 preprocess": "1e83e75a58715eae17f1e161ca3ba552ed2729e7f8f2422dddef35eb494cb4bb",
    "01 index": "c632827b02a3014ba16146463947ba02c667aa076f5ee4b5632977a0a4434155",
    "02 correct": "55a97ce3be593522fd14252ff3406db9fa037bb5bb9411efa17ee1d065616731",
    "03 index": "19d572a431a6cc39335446b0f8a81146aad54d97d68b1d451e904deddb85eaca",
    "04 index": "b9aa547b3fd67259ce0d4e42d4a59568622b054d5c752ab5f3a82dba53e237c1",
    "05 pbhc": "251ac8c11839d07352ae69619baa4709a8c63793d01cca52040e9966ca522aa9",
    "06 index": "91ce642746ecfe24a0d8e421bf599c3915c1b6610ea4bb02beeb4907b42df08c",
    "07 fmwalk": "1636ccb61ae3671bcf05229d9956b25348c24951b98defdf623d7ed3ce6cdece",
    "08 index": "ada2962cb42c6672f1924511c453e77c111d26515e17fef9894c325bfd995de2",
    "09 filter": "860436a27ad3c8ba8e0793f3f7568c9cbf3f46d9b29e99f6a413ed0118edf707",
    "10 index": "06c3256012e0ca36303b460eb585e0751e82c70f2321f2b41f8114570d068ffd",
    "11 overlap": "878c171dbf23f3836887d76d028778278d8189544c88c58b94ef8fed9f96bc34",
    "12 asmlong": "ef4f278cb77f12723295cfbc4c2244dc78c183b6a5ee35eb4328afb102157f4f",
    "13 assemble": "89aa17dd61e4ef6195cc58f16e924cd4bb0809d5843b5f7dc832e3eb4e923262",
    "14 merge": "ea88e34360dd423a40211ea49838a9dc9ba5d4e46b887f577bee2662242ade32",
    "15 oview": "f674b08dc144a8e1e653c1f81f4440ffc4344fb1aa7ada5aff61671b11eaf449",
    "16 subgraph": "2373901c2f013938684068aa68dff6cefca61e26b36fc072001102748b8391bc",
    "17 grep": "f56e9f5141ce553c211aae6ac11d5b418d167c2ecdefee4ed4a8e37a0193d5ba",
    "18 kmerfreq": "201858876a61124de3b513db45b2223cfc8c06b9473a8e106b025b9f4bfc3a04",
    "19 kmercheck": "5c736a6a7757f1877ccec0286e95f6b0f88b862c6dcae99d2b52abd0825cfaa0",
    "20 all": "1dfab3ee718e38592f9b09c061f327735d26c69746b08725ba46cd65a24509c0",
}


def phase_host(smi: str):
    """Phase 16: host subcommands through the port's CLI, each stage's
    outputs held to HOST_DIGESTS."""
    import shutil

    hashorder = os.path.join(REPO, "native", "hashorder.so")
    say("host: the PacBio hybrid pipeline, then assemble, merge, oview, subgraph, grep, "
        "kmerfreq, kmercheck and all, each a `python -m longreadselfcorrect_tpu_torch.cli` "
        "subprocess with PYTHONHASHSEED=0; index on native/fmbuild, pbhc's aligner "
        "native/alnscore.so; native/hashorder.so not built: the digests are the JAX CLI's "
        "without it (overlap_correct's anchors in insertion order)")
    check(not os.path.exists(hashorder),
          "host: native/hashorder.so exists; the digests were taken without it")
    check(os.path.exists(os.path.join(REPO, "native", "fmbuild")), "host: no native/fmbuild")
    d = os.path.join(CACHE, "host")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    genome, runs = run_host_pipeline("longreadselfcorrect_tpu_torch.cli", d)
    for label, argv, rc, so, se, dt, dig in runs:
        say(f"host: {label:<13} {dt:7.2f} s wall, host time on the card's machine ({smi}); "
            f"rc {rc}, digest {dig}")
        check(rc == 0, f"host: {label} {' '.join(argv)} exited {rc}: {se[-3000:]}")
        check(dig == HOST_DIGESTS.get(label),
              f"host: {label} digest {dig}, the JAX CLI's {HOST_DIGESTS.get(label)}")
    check(len(runs) == len(host_stages()), "host: a stage is missing")
    res = host_checks(genome, d)
    say(f"host: {len(runs)} stages in {time.perf_counter() - t0:.1f}s; pbhc pieces in the "
        f"genome {res['pieces_in_genome']}/{res['pieces']}, asmlong contigs {res['contigs']}, "
        f"longest {res['longest']} of {HOST_GENOME_LEN} bp, in the genome "
        f"{res['longest_in_genome']}")
    check(res["pieces"] > 0 and 2 * res["pieces_in_genome"] >= res["pieces"],
          f"host: pbhc pieces in the genome {res}")
    check(res["longest_in_genome"] and res["longest"] >= HOST_ASM_SHARE * HOST_GENOME_LEN,
          f"host: asmlong's longest contig {res}")


def main() -> int:
    import torch

    sys.path.insert(0, REPO)
    name, smi = phase_device()
    phase_build()
    hix, dix, items, extra, dp, seg, nchunk = phase_data()

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams

    params = CorrectionParams(pb_coverage=COVERAGE, genome=10)
    corrector = BatchedSelfCorrector(hix, dix, params)
    rec = phase_kernels(corrector, [("8%", items), ("15%", dp), ("long", seg),
                                    ("N", nchunk)])
    walks, checks = phase_walks(corrector, items)
    rec.update(walks)
    seeds6 = phase_seeds(corrector, hix, items, seg)
    tables, table_launches = phase_tables(corrector, hix, items, seeds6)
    rec.update(tables)
    launches, wx, prep8, fills8 = phase_correct(hix, dix, params, items, checks)
    dp_launches, calls, prep9 = phase_dp(hix, wx, params, dp, checks)
    rec["walk_prep"]["max_abs_err"] = max([rec["walk_prep"]["err"]]
                                          + [r["err"] for r in prep8 + prep9])
    rec.update(phase_msa(hix, dix, calls, fills8))
    turn = phase_throughput(hix, wx, params, extra)
    rec["walk_steps"]["max_abs_err"] = max([rec["walk_steps_one"]["err"],
                                            rec["walk_steps_all"]["err"]]
                                           + [r["err"] for r in checks.steps.values()])
    rec["walk_queue"]["max_abs_err"] = max([rec["walk_queue"]["err"]]
                                           + [r["err"] for r in checks.queue.values()])
    phase_edge(hix, wx, params, items)
    phase_multiproc(os.path.join(CACHE, "stream.fa"), os.path.join(CACHE, "corpus"),
                    correct_fa(extra, turn))
    phase_multigpu(wx, corrector, checks.pool)
    phase_host(smi)
    for k in MSA_KERNELS:
        launches[k] = dp_launches[k]
    launches.update(table_launches)

    kernels = []
    for k, (source, replaces) in KERNEL_INFO.items():
        r = rec[k]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
