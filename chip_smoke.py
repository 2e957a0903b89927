#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: build, exactness, speed.

    python3 chip_smoke.py

Phases, one line each on stdout (a failing phase raises and the script
exits non-zero without the final result line):

1. device   the card's name and power limit (nvidia-smi); no CUDA -> fail
2. build    the five CUDA kernels from longreadselfcorrect_tpu_torch/csrc
            with nvcc, one process per source, all at once
3. data     the bench corpus recipe: a 4 Mb random genome (seed 2026), 30x
            of 2 kb reads (60,000 reads, ~120M symbols per strand) indexed
            with native/fmbuild and packed; 256 noisy 1.5 kb reads at 8%
            error; all under .torch_cache/
4. kernels  each kernel against its plain torch version on the card, on
            the 64-read chunks of the noisy reads, exactly; kernel and plain
            times (CUDA events, median of 5 after one warm-up) and the
            least time the card needs for the same work
5. seeds    the port's seed phase on all 256 noisy reads on the card, held
            field for field against the host search_seeds on 16 of them
6. correct  pbcorrect end to end (BatchedSelfCorrector.process_stream) on
            8 noisy reads, with launch counts reset just before; results
            held against the host SelfCorrector; reads/s and the
            seed/walks/replay split

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".torch_cache")
CORPUS_VERSION = "v1-4mb-30x"
GENOME_LEN = 4_000_000
READ_LEN = 2000
COVERAGE = 30
N_NOISY = 256
N_HOST_SEEDS = 16
N_END_TO_END = 8
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
}


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

def phase_build():
    from longreadselfcorrect_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    paths = cuda.build()
    for lib in cuda.SOURCES:
        cuda.library(lib)
    say(f"build: {len(paths)} libraries ({len(cuda.KERNELS)} kernels) for sm_90a "
        f"in {time.perf_counter() - t0:.2f}s")


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


def ensure_corpus():
    import numpy as np

    from longreadselfcorrect_tpu_torch.core import alphabet as ab

    os.makedirs(CACHE, exist_ok=True)
    stamp = os.path.join(CACHE, CORPUS_VERSION + ".ok")
    corpus = os.path.join(CACHE, "corpus.fa")
    noisy = os.path.join(CACHE, "noisy.fa")
    if os.path.exists(stamp):
        return corpus, noisy
    rng = np.random.default_rng(2026)
    genome = "".join(rng.choice(list("ACGT"), size=GENOME_LEN))
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
    with open(stamp, "w") as f:
        f.write("ok")
    return corpus, noisy


def phase_data():
    from longreadselfcorrect_tpu_torch.index import store
    from longreadselfcorrect_tpu_torch.index.pack import open_index
    from longreadselfcorrect_tpu_torch.io import fasta

    t0 = time.perf_counter()
    corpus, noisy = ensure_corpus()
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
    dev_mb = sum(t.numel() * t.element_size()
                 for fm in (dix.bwt, dix.rbwt) for t in (fm.blocks, fm.ckpt, fm.C)) / 1e6
    say(f"data: genome {GENOME_LEN} bp, {GENOME_LEN * COVERAGE // READ_LEN} reads, "
        f"{hix.bwt.n} symbols per strand, device index {dev_mb:.1f} MB, "
        f"{len(items)} noisy reads (max {max(len(s) for _, s in items)} bp); "
        f"corpus {t_corpus:.1f}s, fmbuild {t_index:.1f}s, pack+upload {t_pack:.1f}s")
    return hix, dix, items


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


def rank_traffic(ix, reads, lens, max_k):
    """(distinct index rows, rank queries) the k-mer table of this chunk
    needs: two queries per live step of each still-valid strand, as the
    kernel issues them."""
    import torch

    from longreadselfcorrect_tpu_torch.ops import rank

    sym0 = reads.long()
    R, L = reads.shape
    state = list(rank.init_bi(ix, sym0.clamp(0, 4)))
    seen = {id(fm): torch.zeros(fm.blocks.shape[0], dtype=torch.bool,
                                device=reads.device) for fm in (ix.rbwt, ix.bwt)}
    queries = 0
    for j in range(1, max_k):
        nxt = torch.full((R, L), 5, dtype=torch.long, device=reads.device)
        nxt[:, : L - j] = sym0[:, j:]
        live = nxt < 5
        s = nxt.clamp(0, 4)
        for fm, lo_i, sym in ((ix.rbwt, 0, s), (ix.bwt, 2, rank.comp(s))):
            lo, hi = state[lo_i], state[lo_i + 1]
            need = live & (lo <= hi)
            queries += 2 * int(need.sum())
            for idx in (lo[need] - 1, hi[need]):
                q = torch.div(idx + 1, fm.block, rounding_mode="floor")
                seen[id(fm)][q.clamp(0, fm.blocks.shape[0] - 1).long()] = True
            nlo, nhi = rank.update_interval(fm, lo, hi, sym)
            state[lo_i] = torch.where(live, nlo, lo)
            state[lo_i + 1] = torch.where(live, nhi, hi)
    rows = sum(int(m.sum()) for m in seen.values())
    return rows, queries


def bound(nbytes: float, nops: float):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / SCALAR_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def phase_kernels(corrector, items):
    """Every kernel against its plain version on every 64-read chunk; times
    and bounds on chunk 0.  Returns {kernel: record}."""
    import torch

    from longreadselfcorrect_tpu_torch.core import alphabet as ab
    from longreadselfcorrect_tpu_torch.core.batch_correct import CHUNK_READS, L_BUCKET
    from longreadselfcorrect_tpu_torch.ops import cuda, scan, seedscan

    import numpy as np

    pp = corrector.probe_params
    ix = corrector.dix
    dev = ix.device
    max_k = pp.kmer_len_up_bound + 1
    K = max_k + 1
    R = CHUNK_READS
    L = max(len(s) for _, s in items)
    L = L_BUCKET * ((L + L_BUCKET - 1) // L_BUCKET)
    thr = torch.from_numpy(np.ascontiguousarray(
        corrector.thresh.table[:, :K])).to(dev)
    rep_thr = float(corrector.thresh.get(2, pp.scan_kmer_len))
    hh = float(pp.hh_ratio)
    bases = torch.arange(1, 5, dtype=torch.int8, device=dev)
    err = {k: 0 for k in KERNEL_INFO}
    rec = {}
    cuda.reset_launches()
    for ci, base in enumerate(range(0, len(items), R)):
        chunk = items[base : base + R]
        mat = np.full((R, L), ab.PAD_RANK, np.int8)
        lens_np = np.zeros(R, np.int32)
        for i, (_, seq) in enumerate(chunk):
            e = ab.encode(seq)
            mat[i, : len(e)] = e
            lens_np[i] = len(e)
        reads = torch.from_numpy(mat).to(dev)
        lens = torch.from_numpy(lens_np).to(dev)
        prefix = torch.zeros((R, L + 1, 4), dtype=torch.int32, device=dev)
        torch.cumsum((reads[:, :, None] == bases).to(torch.int32), dim=1,
                     dtype=torch.int32, out=prefix[:, 1:])

        calls = {
            "kmer_table_full": (
                lambda: scan.kmer_table_full(ix, reads, lens, max_k),
                lambda: scan.kmer_table_full_plain(ix, reads, lens, max_k)),
        }
        freq, valid = calls["kmer_table_full"][0]()
        err["kmer_table_full"] = max(err["kmer_table_full"], max_abs_err(
            (freq, valid), calls["kmer_table_full"][1]()))
        fscan = freq[pp.scan_kmer_len]
        calls["attributes"] = (
            lambda: seedscan.attributes(fscan, prefix, lens, rep_thr, pp.scan_kmer_len),
            lambda: seedscan.attributes_plain(fscan, prefix, lens, rep_thr,
                                              pp.scan_kmer_len))
        attr = calls["attributes"][0]()
        err["attributes"] = max(err["attributes"],
                                max_abs_err(attr, calls["attributes"][1]()))
        auto_args = (freq, valid, attr, prefix, lens, thr, pp.start_kmer_len,
                     pp.kmer_len_up_bound, tuple(pp.offset), hh)
        auto_stats: dict = {}
        calls["scan_automaton"] = (
            lambda: seedscan.scan_automaton(*auto_args),
            lambda: seedscan.scan_automaton_plain(*auto_args))
        auto = calls["scan_automaton"][0]()
        err["scan_automaton"] = max(err["scan_automaton"], max_abs_err(
            auto, seedscan.scan_automaton_plain(*auto_args, stats=auto_stats)))
        n, starts, sizes, freqs, reps, statics = auto
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
        torch.cuda.synchronize()
        if ci:
            continue

        # chunk 0: times, and the least time the card needs for the work
        rows, queries = rank_traffic(ix, reads, lens, max_k)
        nseeds = int(n.sum())
        lane_steps = auto_stats["lane_steps"]
        walk_steps = best_stats["walk_steps"]
        work = {
            # reads + lens in, the two tables out, each touched index row
            # (128 symbols + one checkpoint word) read once; ops: one byte
            # compare per symbol of each query's row
            "kmer_table_full": (R * L + 4 * R + K * R * L * 5 + rows * 132,
                                queries * 128),
            "attributes": (4 * R * L + 16 * R * (L + 1) + 4 * R + 4 * R * L,
                           60 * R * L),
            # attr, prefix, lens, thresholds in; two freq entries and one
            # valid entry per lane-step; the seed records out
            "scan_automaton": (4 * R * L + 16 * R * (L + 1) + 4 * R + 12 * K
                               + 9 * lane_steps + 4 * R + 17 * R * seedscan.SMAX,
                               60 * lane_steps),
            # n, starts, sizes, statics in; one freq entry per pole of each
            # seed plus one per walk step; sk, ek, oor out
            "estimate_best": (4 * R + 12 * R * seedscan.SMAX
                              + 4 * (2 * nseeds + walk_steps)
                              + 9 * R * seedscan.SMAX, 10 * (2 * nseeds + walk_steps)),
            "remove_hitchhiking": (4 * R + 13 * R * seedscan.SMAX + R * seedscan.SMAX,
                                   10 * R * seedscan.SMAX * seedscan.SMAX),
        }
        for k, (kern, plain) in calls.items():
            b_ms, b_by = bound(*work[k])
            rec[k] = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                      "bound_ms": b_ms, "bound_by": b_by}
        rec["_shape"] = dict(R=R, L=L, K=K, rows=rows, queries=queries,
                             lane_steps=lane_steps, walk_steps=walk_steps,
                             seeds=nseeds, chunks=(len(items) + R - 1) // R)
    shape = rec.pop("_shape")
    for k in KERNEL_INFO:
        rec[k]["max_abs_err"] = err[k]
        rec[k]["equal"] = err[k] == 0
    say("kernels: " + json.dumps([
        {"name": k, "equal": r["equal"], "launches": cuda.LAUNCHES[k],
         "ms": round(r["ms"], 4), "plain_ms": round(r["plain_ms"], 4),
         "bound_ms": round(r["bound_ms"], 5)}
        for k, r in rec.items()]) + f" shape {json.dumps(shape)}")
    bad = [k for k, r in rec.items() if not r["equal"]]
    check(not bad, f"kernels: {bad} differ from their plain versions")
    return rec


# ---------------------------------------------------------------------------
# phase 5: the seed phase on all noisy reads
# ---------------------------------------------------------------------------

def _sig(s):
    return (s.seed_start_pos, s.seed_len, s.seed_str, s.max_fixed_mer_freq,
            s.is_repeat, s.start_best_kmer_size, s.end_best_kmer_size)


def phase_seeds(corrector, hix, items):
    import torch

    from longreadselfcorrect_tpu_torch.core import seeds
    from longreadselfcorrect_tpu_torch.ops import cuda

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


# ---------------------------------------------------------------------------
# phase 6: pbcorrect end to end
# ---------------------------------------------------------------------------

COUNTERS = ("merge", "corrected_strs", "total_reads_len", "corrected_len",
            "total_seed_num", "total_walk_num", "high_error_num",
            "exceed_depth_num", "exceed_leave_num", "fm_num", "dp_num", "seed_dis")


def phase_correct(corrector, hix, items):
    import torch

    from longreadselfcorrect_tpu_torch.core.correct import SelfCorrector
    from longreadselfcorrect_tpu_torch.ops import cuda

    batch = items[:N_END_TO_END]
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    results = [r for part in corrector.process_stream([batch]) for r in part]
    dt = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    host = SelfCorrector(hix, corrector.params)
    t1 = time.perf_counter()
    for (rid, seq), res in zip(batch, results):
        want = host.process(rid, seq)
        for name in COUNTERS:
            check(getattr(res, name) == getattr(want, name),
                  f"correct: read {rid} {name} differs from the host SelfCorrector")
    t_host = time.perf_counter() - t1
    pt = corrector.phase_times
    say(f"correct: {len(batch)} reads in {dt:.3f}s = {len(batch) / dt:.4f} reads/s "
        f"(host SelfCorrector {len(batch) / t_host:.4f} reads/s); split seed "
        f"{pt['seed']:.4f}s walks {pt['walks']:.3f}s replay {pt['replay']:.3f}s; "
        f"merged {sum(r.merge for r in results)}/{len(batch)}; launches "
        f"{json.dumps(launches)}; equal to the host SelfCorrector")
    missing = [k for k, v in launches.items() if v <= 0]
    check(not missing, f"correct: kernels {missing} were not launched on the main path")
    return launches


def main() -> int:
    import torch

    sys.path.insert(0, REPO)
    name, _ = phase_device()
    phase_build()
    hix, dix, items = phase_data()

    from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
    from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams

    corrector = BatchedSelfCorrector(hix, dix, CorrectionParams(pb_coverage=COVERAGE,
                                                                genome=10))
    rec = phase_kernels(corrector, items)
    phase_seeds(corrector, hix, items)
    launches = phase_correct(corrector, hix, items)

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
