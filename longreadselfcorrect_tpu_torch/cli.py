"""Command line interface of the torch port: the stride-compatible surface
of StriDe/StriDe.cpp:38-121, every subcommand of the JAX package's CLI.

  all         whole short-read pipeline in one run  (StriDe/strideall.cpp)
  preprocess  quality filter/trim reads             (StriDe/preprocess.cpp)
  index       build BWT/RBWT of a read set          (StriDe/index.cpp)
  correct     short-read EC: kmer/overlap/hybrid    (StriDe/correct.cpp)
  fmwalk      PE merge/validate/kmerize walks       (StriDe/FMIndexWalk.cpp)
  filter      k-mer QC + duplicate removal          (StriDe/filter.cpp)
  merge       FM-merge unambiguous unitigs          (StriDe/fm-merge.cpp)
  overlap     all-vs-all read overlap -> ASQG       (StriDe/overlap.cpp)
  assemble    string-graph contig assembly          (StriDe/assemble.cpp)
  asmlong     long-read string-graph assembly       (StriDe/asmlong.cpp)
  pbcorrect   PacBio self-correction                (StriDe/PacBioSelfCorrection.cpp)
  pbhc        PacBio hybrid correction              (StriDe/PacBioHybridCorrection.cpp)
  kmerfreq    interactive k-mer frequency probe     (StriDe/kmerfreq.cpp)
  kmercheck   k-mer distribution QC report          (StriDe/kmercheck.cpp)
  oview       draw read overlaps from ASQG          (StriDe/oview.cpp)
  subgraph    extract a neighborhood subgraph       (StriDe/subgraph.cpp)
  grep        locate a pattern's reads via the index (StriDe/grep.cpp)

Only pbcorrect reaches the card.  The other subcommands are host code
(numpy, and the ctypes helpers of native/), as in the JAX package: their
arguments, defaults and output files are the JAX CLI's, byte for byte.

pbcorrect's default is the device engine on CUDA: the seed phase, the
FM-extension walks and the MSA/DP fallback's two loops (LF extraction and
the banded DP fill) run as the CUDA kernels of ops/; the DP backtrack and
the consensus stay on the host.  There is no fallback: without a GPU, pass
--device cpu (the plain torch versions) or --engine host (the numpy
engine).

Multi-process mode: start one pbcorrect per rank with --num-processes N
--process-id r (and the same --coordinator host:port, where rank 0 hosts
the rendezvous).  Rank r corrects a contiguous shard of the reads on
cuda:{r % device_count()} (several ranks may share one card) and writes
rank-tagged part files; rank 0 merges them in order and prints the
summary over every rank's counters.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def cmd_index(args) -> int:
    from .core import alphabet as ab
    from .index import build, store
    from .io import fasta

    prefix = args.prefix or os.path.splitext(args.readsfile)[0]
    t0 = time.time()
    if store.fmbuild_path() and not args.pure_python:
        fwd, rev = store.build_with_fmbuild(args.readsfile, prefix)
        print(f"fmbuild: BWT/RBWT ({fwd.num_symbols} symbols) in {time.time()-t0:.1f}s",
              file=sys.stderr)
    else:
        reads = []
        for rec in fasta.read_seqs(args.readsfile):
            reads.append(ab.encode(rec.seq))
        print(f"Read {len(reads)} sequences", file=sys.stderr)
        fwd, rev = build.build_bwt_pair(reads)
        print(f"Built BWT/RBWT ({fwd.num_symbols} symbols) in {time.time()-t0:.1f}s",
              file=sys.stderr)
    store.save_native(prefix, fwd, rev)
    if args.ref_format:
        store.save_reference_bwt(prefix + ".bwt", fwd)
        store.save_reference_bwt(prefix + ".rbwt", rev)
    print(f"Wrote {prefix}{store.NATIVE_SUFFIX} / {prefix}{store.RNATIVE_SUFFIX}",
          file=sys.stderr)
    return 0


def make_corrector(args, params):
    """The engine pbcorrect asked for: SelfCorrector (host) or
    BatchedSelfCorrector with its index on --device (rank r of a
    multi-process run on cuda:{r % device_count()})."""
    from .core.correct import SelfCorrector
    from .index.pack import open_index

    if args.engine == "host":
        return SelfCorrector(open_index(args.prefix, device=None)[0], params)
    import torch

    from .core.batch_correct import BatchedSelfCorrector
    from .ops import walk
    from .parallel.distributed import rank_device

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pbcorrect --device cuda: no CUDA device is available "
                           "(use --device cpu or --engine host)")
    cfg = None
    if args.walk_config:
        g_, ml, qm, ws = (int(x) for x in args.walk_config.split(","))
        cfg = walk.WalkConfig(G=g_, MAXLEN=ml, QMAX=qm, WSCAN=ws)
    hix, dix = open_index(args.prefix, device=rank_device(args.process_id, args.device))
    return BatchedSelfCorrector(hix, dix, params, cfg=cfg)


def open_corrector(args, params):
    """make_corrector; in a multi-process run rank 0 opens the index first
    (packing it and writing its walk tables on first use) while the other
    ranks wait, then they open what it wrote."""
    if args.num_processes > 1:
        from .parallel import distributed as dist

        return dist.rank0_first(lambda: make_corrector(args, params), "index")
    return make_corrector(args, params)


def batched(items, n):
    """Lists of n consecutive items (the last one shorter)."""
    batch = []
    for item in items:
        batch.append(item)
        if len(batch) == n:
            yield batch
            batch = []
    if batch:
        yield batch


def cmd_pbcorrect(args) -> int:
    from .core.correct import CorrectionParams
    from .io import fasta

    dist_mode = args.num_processes > 1
    if dist_mode:
        from .parallel import distributed as dist

        dist.init(args.coordinator, args.num_processes, args.process_id)
    params = CorrectionParams(
        pb_coverage=args.PBcoverage,
        error_rate=args.error_rate,
        next_target=args.next_target,
        max_leaves=args.max_leaves,
        idmer_len=args.idmer_length,
        min_kmer_len=args.min_kmer_size,
        genome=args.genome,
        mode=args.mode if args.mode is not None else 1,
        manual=args.mode is not None,
        adjust=args.kmer_size is not None,
        start_kmer_len=args.kmer_size or 19,
        split=args.split,
        no_dp=args.nodp,
        only_seed=args.onlyseed,
        debug_seed=args.debugseed or args.onlyseed,
        directory=args.output,
    )
    if args.onlyseed:
        return _pbcorrect_onlyseed(args, params)
    corrector = open_corrector(args, params)
    use_device = args.engine == "device"
    os.makedirs(args.output, exist_ok=True)
    # threshold-table dump: the reference writes it whenever the output
    # directory exists (KmerThreshold::initialize -> dtor, KmerThreshold.cpp:
    # 33-41,50; StriDe/PacBioSelfCorrection.cpp:231); one rank writes it
    if args.process_id == 0:
        corrector.thresh.write_table(os.path.join(args.output, "threshold-table"))

    totals = dict(
        reads_len=0, corrected_len=0, seed_num=0, walk_num=0, high_error=0,
        exceed_depth=0, exceed_leave=0, fm=0, dp=0, seed_dis=0,
        t_seed=0.0, t_fm=0.0, t_dp=0.0,
    )
    t0 = time.time()
    n = 0

    # multi-process mode: a contiguous read shard per process, rank-tagged
    # part files, the ranks' counters summed, then the rank-0 ordered
    # merge -- the cross-process analog of the reference's ordered
    # single-sink PostProcess (Concurrency/SequenceProcessFramework.h:183-195)
    def work_records():
        if not dist_mode:
            for rec in fasta.read_seqs(args.readsfile):
                yield rec.id, rec.seq
            return
        all_items = [(r.id, r.seq) for r in fasta.read_seqs(args.readsfile)]
        lo, hi = dist.shard_bounds(len(all_items), args.num_processes,
                                   args.process_id)
        yield from all_items[lo:hi]

    def result_stream():
        if use_device:
            # batch k+1's device seed phase overlaps batch k's host workflow
            all_batches = list(batched(work_records(), args.batch_reads))
            for batch, results in zip(all_batches,
                                      corrector.process_stream(all_batches)):
                yield from zip(batch, results)
        else:
            for rid, seq in work_records():
                yield (rid, seq), corrector.process(rid, seq)

    correct_path = os.path.join(args.output, "correct.fa")
    discard_path = os.path.join(args.output, "discard.fa")
    if dist_mode:
        correct_path = dist.part_path(correct_path, args.process_id)
        discard_path = dist.part_path(discard_path, args.process_id)
    with open(correct_path, "w") as fcorrect, open(discard_path, "w") as fdiscard:
        for (rec_id, rec_seq), result in result_stream():
            n += 1
            if result.merge:
                totals["reads_len"] += result.total_reads_len
                totals["corrected_len"] += result.corrected_len
                totals["seed_num"] += result.total_seed_num
                totals["walk_num"] += result.total_walk_num
                totals["high_error"] += result.high_error_num
                totals["exceed_depth"] += result.exceed_depth_num
                totals["exceed_leave"] += result.exceed_leave_num
                totals["fm"] += result.fm_num
                totals["dp"] += result.dp_num
                totals["seed_dis"] += result.seed_dis
                totals["t_seed"] += result.timer_seed
                totals["t_fm"] += result.timer_fm
                totals["t_dp"] += result.timer_dp
                for i, s in enumerate(result.corrected_strs):
                    flag = f"_{i}" if params.split else ""
                    fasta.write_fasta(fcorrect, rec_id + flag, s)
            else:
                fasta.write_fasta(fdiscard, rec_id, rec_seq)
            if n % 100 == 0:
                dt = time.time() - t0
                print(f"Processed {n} sequences in {dt:.1f}s ({n/dt:.1f} sequences/s)",
                      file=sys.stderr)
    # the stream's window on the wall clock (seconds since the epoch), so
    # that the windows of several ranks can be laid side by side
    print(f"Stream of {n} sequences from {t0:.6f} to {time.time():.6f}", file=sys.stderr)

    if dist_mode:
        # the store's counter sum doubles as the parts-written barrier: every
        # rank publishes after closing its part files and waits until all
        # ranks' counters exist; then rank 0 merges in rank order
        import numpy as np

        keys = sorted(totals)
        summed = dist.kv_counter_sum(np.array([totals[k] for k in keys], np.float64),
                                     args.num_processes, args.process_id)
        for k, v in zip(keys, summed):
            totals[k] = type(totals[k])(v)
        if args.process_id != 0:
            return 0
        dist.merge_ordered_parts(os.path.join(args.output, "correct.fa"),
                                 args.num_processes)
        dist.merge_ordered_parts(os.path.join(args.output, "discard.fa"),
                                 args.num_processes)

    # summary mirrors PacBioSelfCorrectionPostProcess dtor (:288-306)
    if totals["walk_num"] > 0 and totals["reads_len"] > 0:
        outcast = totals["walk_num"] - totals["fm"] - totals["dp"]
        dp_outcast = totals["dp"] + outcast
        print(
            f"\nTotalReadsLen: {totals['reads_len']}\n"
            f"CorrectedLen: {totals['corrected_len']}, ratio: "
            f"{totals['corrected_len']/totals['reads_len']:g}\n"
            f"TotalSeedNum: {totals['seed_num']}\n"
            f"TotalWalkNum: {totals['walk_num']}\n"
            f"FMNum: {totals['fm']}, ratio: {totals['fm']*100/totals['walk_num']:g}%\n"
            f"DPNum: {totals['dp']}, ratio: {totals['dp']*100/totals['walk_num']:g}%\n"
            f"OutcastNum: {outcast}, ratio: {outcast*100/totals['walk_num']:g}%"
        )
        if dp_outcast > 0:
            print(
                f"HighErrorNum: {totals['high_error']}, ratio: "
                f"{totals['high_error']*100/dp_outcast:g}%\n"
                f"ExceedDepthNum: {totals['exceed_depth']}, ratio: "
                f"{totals['exceed_depth']*100/dp_outcast:g}%\n"
                f"ExceedLeaveNum: {totals['exceed_leave']}, ratio: "
                f"{totals['exceed_leave']*100/dp_outcast:g}%"
            )
        print(f"DisBetweenSeeds: {totals['seed_dis']//totals['walk_num']}")
        # per-phase timer summary (PacBioSelfCorrectionProcess.cpp:303-305)
        print(f"Time of searching Seeds: {totals['t_seed']:g}\n"
              f"Time of searching FM: {totals['t_fm']:g}\n"
              f"Time of searching DP: {totals['t_dp']:g}")
    return 0


def _onlyseed_seeds(args, corrector):
    """(rid, seq, seeds) of every read: the host engine's search_seeds, or
    the device seed phase batch by batch (the kept seeds, and the
    --debugseed seed dumps the host engine writes)."""
    from .io import fasta

    records = ((rec.id, rec.seq) for rec in fasta.read_seqs(args.readsfile))
    if args.engine == "host":
        for rid, seq in records:
            yield rid, seq, corrector.process(rid, seq).seeds or []
        return

    for batch in batched(records, args.batch_reads):
        for _, chunk, seeds_lists in corrector._device_seed_scan(batch):
            for (rid, seq), seeds in zip(chunk, seeds_lists):
                corrector._dump_seeds(rid, seeds)
                yield rid, seq, seeds


def _pbcorrect_onlyseed(args, params) -> int:
    """--onlyseed: score seed positions against barcode ground truth
    (PacBioSelfCorrectionProcess.cpp:315-335,372-380), with the seeds of
    --engine's seed phase."""
    from .core import bcode

    if not args.barcode:
        print("pbcorrect --onlyseed requires -b/--barcode", file=sys.stderr)
        return 1
    blocks_by_read = bcode.load_barcode(args.barcode)
    corrector = open_corrector(args, params)
    os.makedirs(args.output, exist_ok=True)
    totals = [0, 0, 0]
    with open(os.path.join(args.output, "total.seed"), "w") as fh:
        for rid, seq, seeds in _onlyseed_seeds(args, corrector):
            status = bcode.score_seeds(seeds, blocks_by_read.get(rid, []), seq)
            line = bcode.summarize_line(rid, status)
            if line:
                fh.write(line + "\n")
            for i in range(3):
                totals[i] += status[i]
    # the aggregate goes to stdout, not total.seed
    # (PacBioSelfCorrectionProcess.cpp:285: summarize(stdout, ..., "TOTAL"))
    line = bcode.summarize_line("TOTAL", totals)
    if line:
        print(line)
    return 0


def _load_host_index(prefix: str):
    from .index.pack import open_index

    return open_index(prefix, device=None)[0]


def cmd_merge(args) -> int:
    """FM-merge unambiguously-overlapping reads (StriDe/fm-merge.cpp:83)."""
    from .graph.fmmerge import FMMerger
    from .index import store
    from .io import fasta

    ix = _load_host_index(args.prefix)
    lex_fwd = store.load_sampled_sa(args.prefix, ix.bwt).lex
    lex_rev = store.load_sampled_sa(args.prefix, ix.rbwt, reverse=True).lex
    records = [(rec.id, rec.seq) for rec in fasta.read_seqs(args.readsfile)]
    merger = FMMerger(ix, records, lex_fwd, lex_rev, args.min_overlap)
    n = total_len = 0
    with open(args.out, "w") as f:
        for rid, seq in merger.merge_all():
            fasta.write_fasta(f, rid, seq)
            n += 1
            total_len += len(seq)
    print(f"[fm-merge] Merged {len(records)} reads into {n} sequences",
          file=sys.stderr)
    if n:
        print(f"[fm-merge] Reduction factor: {len(records)/n:g}\n"
              f"[fm-merge] Mean merged size: {total_len/n:g}", file=sys.stderr)
    return 0


def cmd_grep(args) -> int:
    """Pattern search in the index with read-ID resolution (grep.cpp:56)."""
    from .core import alphabet as ab
    from .index.host import read_id_of
    from .io import fasta

    ix = _load_host_index(args.prefix)
    reads = [rec for rec in fasta.read_seqs(args.readsfile)]
    for query in sys.stdin.read().split():
        print("--")
        lo, hi = ix.bwt.find_interval(ab.encode(query))
        if lo <= hi:
            for row in range(int(lo), int(hi) + 1):
                rid, off = read_id_of(ix.bwt, row)
                rec = reads[rid]
                print(rec.id)
                print(f"{rec.seq[:off]}[{rec.seq[off:off+len(query)]}]"
                      f"{rec.seq[off+len(query):]}")
        print("--")
    return 0


def cmd_pbhc(args) -> int:
    """PacBio hybrid correction (StriDe/PacBioHybridCorrection.cpp:160-260)."""
    from .core.hybrid import HybridCorrector, HybridParams
    from .io import fasta

    ix = _load_host_index(args.prefix)
    pb_prefix = args.PBprefix or os.path.splitext(args.readsfile)[0]
    pb_ix = _load_host_index(pb_prefix)
    read_len = args.readlen
    params = HybridParams(
        kmer_length=args.kmer_size,
        min_kmer_length=args.min_seed_length,
        max_overlap=(args.max_overlap if args.max_overlap >= 0
                     else int(read_len * 0.9 + 1)),
        min_overlap=(args.min_overlap if args.min_overlap >= 0
                     else int(read_len * 0.8 + 1)),
        max_leaves=args.max_leaves,
        fmw_kmer_threshold=args.fmw_threshold,
        coverage=args.coverage if args.coverage > 0 else 100,
        pb_kmer_length=args.PBkmer_length,
        pb_coverage=args.PBcoverage,
        pb_search_depth=args.PBsearch_depth,
    )
    corr = HybridCorrector(ix, pb_ix, params)
    out = args.outfile or (os.path.splitext(args.readsfile)[0] + ".ec.fa")
    discard = os.path.splitext(out)[0] + ".discard.fa"
    totals = dict(reads_len=0, corrected_len=0, seeds=0, walks=0, corrected=0,
                  seed_dis=0)
    n = 0
    t0 = time.time()
    with open(out, "w") as fc, open(discard, "w") as fd:
        for rec in fasta.read_seqs(args.readsfile):
            res = corr.correct(rec.id, rec.seq)
            n += 1
            if res["merge"]:
                totals["reads_len"] += res["total_reads_len"]
                totals["corrected_len"] += res["corrected_len"]
                totals["seeds"] += res["total_seed_num"]
                totals["walks"] += res["walk_num"]
                totals["corrected"] += res["corrected_num"]
                totals["seed_dis"] += res["seed_dis"]
                for i, s_ in enumerate(res["corrected_strs"]):
                    fasta.write_fasta(fc, f"{rec.id}_{i}_{len(s_)}", s_)
            else:
                fasta.write_fasta(fd, rec.id, rec.seq)
            if n % 100 == 0:
                dt = time.time() - t0
                print(f"Processed {n} sequences in {dt:.1f}s"
                      f" ({n/dt:.1f} sequences/s)", file=sys.stderr)
    # summary mirrors PacBioHybridCorrectionPostProcess dtor (:1290-1310)
    if totals["walks"] > 0 and totals["reads_len"] > 0:
        print(f"totalReadsLen: {totals['reads_len']}, "
              f"correctedLen: {totals['corrected_len']}, ratio: "
              f"{totals['corrected_len']/totals['reads_len']:g}%.")
        print(f"totalSeedNum: {totals['seeds']}.")
        print(f"totalWalkNum: {totals['walks']}, "
              f"correctedNum: {totals['corrected']}, ratio: "
              f"{totals['corrected']*100/totals['walks']:g}%.")
        print(f"seedDis: {totals['seed_dis']/totals['walks']:g}.")
    return 0


def cmd_kmercheck(args) -> int:
    """Correct-vs-error k-mer distributions under a barcode ground truth
    (StriDe/kmercheck.cpp:77, PacBio/KmerCheckProcess.cpp:12-66)."""
    from .core import alphabet as ab
    from .core import bcode as bc
    from .core import kmercheck as kc
    from .io import fasta

    ix = _load_host_index(args.prefix)
    log = bc.load_barcode(args.barcode)
    os.makedirs(args.directory, exist_ok=True)
    crt_map: dict = {}
    err_map: dict = {}
    n = 0
    print(f"Using kmer size : {args.lower} - {args.upper} ({args.step})",
          file=sys.stderr)
    for rec in fasta.read_seqs(args.readsfile):
        blocks = log.get(rec.id)
        if not blocks:
            continue
        freq, _valid = ix.kmer_freq_table(ab.encode(rec.seq), args.upper)
        kc.scan_read(lambda k, pos: freq[k][pos], rec.seq, blocks,
                     args.lower, args.upper, args.step, crt_map, err_map)
        n += 1
    with open(os.path.join(args.directory, "total.box"), "a") as ft, open(
        os.path.join(args.directory, "value.box"), "a"
    ) as fv:
        for k in range(args.lower, args.upper + 1, args.step):
            tline, vline = kc.compare_lines(
                args.coverage, k,
                crt_map.get(k, kc.KmerDistribution()),
                err_map.get(k, kc.KmerDistribution()),
            )
            ft.write(tline + "\n")
            fv.write(vline + "\n")
    print(f"kmercheck: {n} reads scanned -> "
          f"{args.directory}/total.box value.box", file=sys.stderr)
    return 0


def cmd_kmerfreq(args) -> int:
    from .core import alphabet as ab
    from .core.threshold import KmerThreshold

    ix = _load_host_index(args.prefix)
    thresh = KmerThreshold(-1, 100, args.PBcoverage)
    print("Please enter query sequence, kmer size and mode:", file=sys.stderr)
    tokens = sys.stdin.read().split()
    it = iter(tokens)
    while True:
        try:
            query = next(it)
            static_size = int(next(it))
            mode = int(next(it))
        except StopIteration:
            break
        qlen = len(query)
        freq, valid = ix.kmer_freq_table(ab.encode(query), min(qlen, 150))
        dynamic_size = static_size
        for pos in range(0, qlen - static_size + 1):
            sw = query[pos : pos + static_size]
            sfreq = int(freq[static_size][pos])
            dsize = dynamic_size
            dw = query[0 : dsize]
            dfreq = int(freq[dsize][0]) if dsize <= min(qlen, 150) else -1
            print(
                f"{pos}\t{sw}\t{sfreq} <-> {thresh.get(mode, static_size):g}\t"
                f"{dw}\t{dfreq} <-> {thresh.get(mode, dsize):g}"
            )
            dynamic_size += 1
        print("-")
    print("Exit successfully!", file=sys.stderr)
    return 0


def cmd_preprocess(args) -> int:
    import random

    from .core import preprocess as pp
    from .io import fasta

    params = pp.PreprocessParams(
        quality_trim=args.quality_trim,
        hard_clip=args.hard_clip,
        min_length=args.min_length,
        quality_filter=args.quality_filter,
        discard_quality=args.no_quality,
        discard_ambiguous=not args.permute_ambiguous,
        dust=args.dust,
        dust_threshold=args.dust_threshold,
        phred64=args.phred64,
        primer_check=not args.no_primer_check,
        pe_mode=args.pe_mode,
        sample_freq=args.sample,
        suffix=args.suffix,
    )
    stats = pp.PreprocessStats()
    rng = random.Random(0)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    orphan = open(args.pe_orphans, "w") if args.pe_orphans else None

    def write_rec(f, rid, seq, qual):
        if qual:
            f.write(f"@{rid}\n{seq}\n+\n{qual}\n")
        else:
            f.write(f">{rid}\n{seq}\n")

    def sample_pass():
        return params.sample_freq >= 1.0 or rng.random() < params.sample_freq

    files = list(args.readsfile)
    if params.pe_mode == 0:
        # SE path (preprocess.cpp:209-231)
        for path in files:
            for rec in fasta.read_seqs(path):
                res = pp.process_read(rec.seq, rec.qual, params, stats, rng)
                if res is None or not sample_pass():
                    continue
                seq, qual = res
                rid = rec.id + params.suffix if params.suffix else rec.id
                write_rec(out, rid, seq, qual)
                stats.reads_kept += 1
                stats.bases_kept += len(seq)
    else:
        # PE path (preprocess.cpp:233-321): mode 1 = two files in lockstep,
        # mode 2 = interleaved records in one file; a failed half orphans
        # its mate (written to --pe-orphans if given, else dropped)
        if params.pe_mode == 1 and len(files) % 2 == 1:
            print("Error: An even number of files must be given for pe-mode 1",
                  file=sys.stderr)
            return 1
        streams = []
        if params.pe_mode == 1:
            for i in range(0, len(files), 2):
                r1 = fasta.read_seqs(files[i])
                r2 = fasta.read_seqs(files[i + 1])
                streams.append(zip(r1, r2))
        else:
            for path in files:
                it = iter(fasta.read_seqs(path))
                streams.append(zip(it, it))
        for stream in streams:
            for rec1, rec2 in stream:
                id1, id2 = rec1.id, rec2.id
                if id1 == id2:
                    if params.suffix:
                        id1 += params.suffix
                        id2 += params.suffix
                    id1 += "/1"
                    id2 += "/2"
                # pair-name sanity check: warn + count, do NOT discard
                # (preprocess.cpp:289-297)
                if pp.get_pair_id(id2) != id1 or pp.get_pair_id(id1) != id2:
                    print(f"Warning: Pair IDs do not match (expected format "
                          f"/1,/2 or /A,/B)\nRead1 ID: {id1}\nRead2 ID: {id2}",
                          file=sys.stderr)
                    stats.invalid_pe += 2
                res1 = pp.process_read(rec1.seq, rec1.qual, params, stats, rng)
                res2 = pp.process_read(rec2.seq, rec2.qual, params, stats, rng)
                if not sample_pass():
                    continue
                if res1 is not None and res2 is not None:
                    write_rec(out, id1, *res1)
                    write_rec(out, id2, *res2)
                    stats.reads_kept += 2
                    stats.bases_kept += len(res1[0]) + len(res2[0])
                elif res1 is not None and orphan is not None:
                    write_rec(orphan, id1, *res1)
                elif res2 is not None and orphan is not None:
                    write_rec(orphan, id2, *res2)

    if orphan is not None:
        orphan.close()
    rk = stats.reads_kept / stats.reads_read if stats.reads_read else 0.0
    bk = stats.bases_kept / stats.bases_read if stats.bases_read else 0.0
    rp = stats.reads_primer / stats.reads_read if stats.reads_read else 0.0
    print(
        f"Reads parsed:\t{stats.reads_read}\nReads kept:\t{stats.reads_kept}"
        f" ({rk:g})\n"
        f"Reads failed primer screen:\t{stats.reads_primer} ({rp:g})\n"
        f"Bases parsed:\t{stats.bases_read}\nBases kept:\t{stats.bases_kept}"
        f" ({bk:g})\n"
        f"Number of incorrectly paired reads that were discarded: "
        f"{stats.invalid_pe}",
        file=sys.stderr,
    )
    return 0


def cmd_all(args) -> int:
    """One-command short-read pipeline (StriDe/strideall.cpp:89-330):
    preprocess -> index -> correct(overlap) -> index -> fmwalk -> merge
    outputs -> index -> filter -> index -> overlap -> assemble.

    Stage arguments mirror the reference's hardcoded invocations
    (strideall.cpp:94-322); one deliberate fix: the reference always passes
    `-p 1` to preprocess (strideall.cpp:98-99) which breaks its own
    `all -p 2` interleaved mode, while we forward the requested pe-mode."""
    d = os.path.abspath(args.dir)
    os.makedirs(d, exist_ok=True)
    min_overlap = args.min_overlap or int(args.read_length * 0.8)
    k, c = str(args.kmer_size), str(args.kmer_threshold)

    def stage(name, argv):
        print(f"\n\t[ stride all: {name} ]\n", file=sys.stderr, flush=True)
        rc = main(argv)
        if rc != 0:
            print(f"stage {name} failed (rc={rc})", file=sys.stderr)
            raise SystemExit(rc)

    reads = os.path.join(d, "reads.fa")
    ec = os.path.join(d, "READ.ECOLr.fasta")
    ec_prefix = os.path.splitext(ec)[0]
    merged = os.path.join(d, "merged.fa")
    fpass = os.path.join(d, "merged.filter.pass.fa")
    asqg = os.path.join(d, "merged.filter.pass.asqg.gz")

    stage("preprocess", ["preprocess", "--no-quality",
                         "-p", str(args.pe_mode), "-o", reads]
          + list(args.readsfile))
    stage("index reads", ["index", reads])
    stage("correct", ["correct", "-a", "overlap", "-R", "1",
                      "-k", k, "-x", c,
                      "-p", os.path.splitext(reads)[0], "-o", ec, reads])
    stage("index corrected", ["index", ec])
    # fmwalk stage (strideall.cpp:200-228): -m minOverlap -L 64 leaves,
    # max insert = 2 * insert size, hybrid MergeAndKmerize
    merge_out = os.path.join(d, "READ.ECOLr.merge.fa")
    kmerized = os.path.join(d, "READ.ECOLr.kmerized.fa")
    stage("fmwalk", ["fmwalk", "-a", "hybrid", "-m", str(min_overlap),
                     "-l", "64", "-L", str(2 * args.insert_size),
                     "-k", k, "-x", c, "-p", ec_prefix,
                     "-o", merge_out, "--discard", kmerized, ec])
    # cat merge + kmerized -> merged.fa (strideall.cpp:231-244)
    with open(merged, "w") as out:
        for part in (merge_out, kmerized):
            if os.path.exists(part):
                with open(part) as f:
                    out.write(f.read())
    if os.path.exists(kmerized):
        os.unlink(kmerized)
    stage("index merged", ["index", merged])
    stage("filter", ["filter", "--no-kmer-check",
                     "-p", os.path.splitext(merged)[0], "-o", fpass, merged])
    # the reference's filter --rebuild-BWT re-indexes the kept reads in
    # place; we run an explicit index stage instead
    stage("index filtered", ["index", fpass])
    stage("overlap", ["overlap", "--exact", "-m", str(args.kmer_size - 1),
                      "-p", os.path.splitext(fpass)[0], "-o", asqg, fpass])
    stage("assemble", ["assemble", "-k", k, "-t", c,
                       "-p", ec_prefix,
                       "-i", str(args.insert_size),
                       "-r", str(args.read_length),
                       "-c", str(min_overlap),
                       "-o", os.path.join(d, "StriDe"), asqg])
    print(f"\nall done: contigs at {os.path.join(d, 'StriDe-contigs.fa')}",
          file=sys.stderr)
    return 0


def cmd_correct(args) -> int:
    from .core.kmer_correct import CorrectionThresholds, KmerCorrectParams, kmer_correct
    from .io import fasta

    ix = _load_host_index(args.prefix)
    lex = None
    reads_by_rank = None
    if args.algorithm in ("overlap", "hybrid"):
        from .core.overlap_correct import overlap_correction
        from .index import store

        lex = store.load_sampled_sa(args.prefix, ix.bwt).lex
        reads_by_rank = None  # extract matched reads from the BWT itself
    th = CorrectionThresholds()
    if args.kmer_threshold is not None:
        th.set_base_min_support(args.kmer_threshold)
    params = KmerCorrectParams(
        kmer_length=args.kmer_size, num_kmer_rounds=args.kmer_rounds, thresholds=th
    )
    kmer_passed = overlap_passed = failed = 0
    threshold = max(th.required_support(0) - 1, 0)
    fdiscard = open(args.discard, "w") if args.discard else None
    with open(args.out, "w") as f:
        for rec in fasta.read_seqs(args.readsfile):
            kmer_qc = overlap_qc = False
            if args.algorithm == "overlap":
                seq, overlap_qc = overlap_correction(
                    ix, lex, reads_by_rank, rec.seq, args.kmer_size,
                    args.overlap_rounds, 1.0 - args.error_rate, threshold)
            elif args.algorithm == "hybrid":
                seq, kmer_qc = kmer_correct(ix, rec.seq, rec.qual, params)
                if not kmer_qc:
                    seq, overlap_qc = overlap_correction(
                        ix, lex, reads_by_rank, rec.seq, args.kmer_size,
                        args.overlap_rounds, 1.0 - args.error_rate, threshold)
            else:
                seq, kmer_qc = kmer_correct(ix, rec.seq, rec.qual, params)
            # QC tallies + discard routing: ErrorCorrectProcess.cpp:591-635
            qc = kmer_qc or overlap_qc
            if kmer_qc:
                kmer_passed += 1
            elif overlap_qc:
                overlap_passed += 1
            else:
                failed += 1
            if not seq:
                continue
            if qc or fdiscard is None:
                # without a discard writer the reference keeps failed reads
                # in the main output
                fasta.write_fasta(f, rec.id, seq)
            else:
                fasta.write_fasta(fdiscard, rec.id, seq)
    if fdiscard is not None:
        fdiscard.close()
    print(f"Reads passed kmer QC check: {kmer_passed}", file=sys.stderr)
    print(f"Reads passed overlap QC check: {overlap_passed}", file=sys.stderr)
    print(f"Reads failed QC: {failed}", file=sys.stderr)
    return 0


def cmd_fmwalk(args) -> int:
    from .core import alphabet as ab
    from .core.pe_merge import (kmerize_read, merge_and_kmerize, merge_pair,
                                validate_read)
    from .core.qc import median_kmer_frequency
    from .io import fasta

    ix = _load_host_index(args.prefix)
    recs = list(fasta.read_seqs(args.readsfile))
    n_merge = n_kmerize = n_fail = 0
    threshold = args.kmer_threshold
    fdiscard = open(args.discard, "w") if args.discard else None

    def write_kmerized(fd, rid, main, others):
        if main:
            fasta.write_fasta(fd, rid, main)
        for i, p in enumerate(others):
            fasta.write_fasta(fd, f"{rid}:{i}", p)

    with open(args.out, "w") as f:
        if args.algorithm == "validate":
            for rec in recs:
                code, seq = validate_read(ix, rec.seq, args.min_overlap,
                                          sa_threshold=threshold)
                if code == 1:
                    fasta.write_fasta(f, rec.id, seq)
                    n_merge += 1
                else:
                    n_fail += 1
        elif args.algorithm == "kmerize":
            for rec in recs:
                ok, main, others = kmerize_read(ix, rec.seq, args.kmer_size,
                                                threshold)
                if ok:
                    n_kmerize += 1
                    write_kmerized(fdiscard or f, rec.id, main, others)
                else:
                    n_fail += 1
        elif args.algorithm == "hybrid":
            # MergeAndKmerize over consecutive pairs (FMW_HYBRID)
            # size_t truncation: the reference stores q2*1.3 in a size_t
            # (FMIndexWalkProcess.cpp:402), so 9*1.3=11.7 compares as 11
            repeat_freq = int(median_kmer_frequency(ix, args.min_overlap) * 1.3)
            for i in range(0, len(recs) - 1, 2):
                r1, r2 = recs[i], recs[i + 1]
                res = merge_and_kmerize(
                    ix, r1.seq, r2.seq, args.kmer_size, threshold,
                    args.min_overlap,
                    args.max_overlap if args.max_overlap > 0 else
                    int((len(r1.seq) + len(r2.seq)) / 2 * 0.95),
                    args.max_insert, args.max_leaves, repeat_freq)
                if res["merge"]:
                    n_merge += 1
                    fasta.write_fasta(f, r1.id.split("/")[0], res["seq"])
                else:
                    n_kmerize += int(res["kmerize"]) + int(res["kmerize2"])
                    n_fail += int(not res["kmerize"]) + int(not res["kmerize2"])
                    write_kmerized(fdiscard or f, r1.id, res["main1"],
                                   res["others1"])
                    write_kmerized(fdiscard or f, r2.id, res["main2"],
                                   res["others2"])
        else:  # merge: consecutive pairs, 2nd read reverse-complemented
            for i in range(0, len(recs) - 1, 2):
                r1, r2 = recs[i], recs[i + 1]
                code, seq = merge_pair(
                    ix, r1.seq, ab.revcomp_str(r2.seq), args.min_overlap,
                    args.max_overlap, args.max_insert,
                    sa_threshold=threshold,
                )
                if code == 1:
                    fasta.write_fasta(f, r1.id + ":merged", seq)
                    n_merge += 1
                else:
                    n_fail += 1
    if fdiscard is not None:
        fdiscard.close()
    print(f"Reads are kmerized: {n_kmerize}", file=sys.stderr)
    print(f"Reads are merged : {n_merge}", file=sys.stderr)
    print(f"Reads failed to kmerize or merge: {n_fail}", file=sys.stderr)
    return 0


def cmd_filter(args) -> int:
    from .core.qc import QCParams, filter_reads
    from .io import fasta

    ix = _load_host_index(args.prefix)
    params = QCParams(
        kmer_length=args.kmer_size, kmer_threshold=args.kmer_threshold,
        check_kmer=not args.no_kmer_check,
        check_duplicates=not args.no_duplicate_check,
        substring_only=args.substring_only,
    )
    kept = dropped = 0
    discard = args.discard or (args.out + ".discard.fa")
    with open(args.out, "w") as f, open(discard, "w") as fd:
        for i, (rec, passed) in enumerate(
                filter_reads(ix, fasta.read_seqs(args.readsfile), params)):
            if passed:
                fasta.write_fasta(f, rec.id, rec.seq)
                kept += 1
            else:
                # the reference annotates discards with their sequence rank
                # (QCProcess dup-removal metadata)
                fasta.write_fasta(fd, f"{rec.id},seqrank={i}", rec.seq)
                dropped += 1
    print(f"kept: {kept}, filtered: {dropped}", file=sys.stderr)
    return 0


def cmd_overlap(args) -> int:
    """All-vs-all read overlap -> ASQG (StriDe/overlap.cpp:126).

    -e RATE >= 0 dispatches the inexact LSSF FM-walk engine with indel
    tolerance -l (StriDe/overlap.cpp:190-192); transitive reduction is
    disabled for inexact overlaps (:388-393)."""
    from .graph import asqg, overlap as ovl
    from .index import store
    from .io import fasta

    ix = _load_host_index(args.prefix)
    lex_fwd = store.load_sampled_sa(args.prefix, ix.bwt).lex
    lex_rev = store.load_sampled_sa(args.prefix, ix.rbwt, reverse=True).lex
    records = [(rec.id, rec.seq) for rec in fasta.read_seqs(args.readsfile)]
    out = args.out or (os.path.splitext(os.path.basename(args.readsfile))[0] + ".asqg.gz")
    from .graph.asqg import Header, _open
    inexact = args.error_rate >= 0
    with _open(out, "w") as fh:
        fh.write(Header(error_rate=max(args.error_rate, 0.0),
                        min_overlap=args.min_overlap,
                        infile=args.readsfile).to_line() + "\n")
        edges = []
        stats = ovl.overlap_all(
            ix, records, args.min_overlap, lex_fwd, lex_rev,
            on_vertex=lambda rid, seq, is_sub: asqg.write_vertex(fh, rid, seq, is_sub),
            on_edge=edges.append,
            irreducible=args.exact and not inexact,
            error_rate=args.error_rate, max_indel=args.maxindel,
        )
        for o in edges:
            asqg.write_edge(fh, o)
    print(f"overlap: {len(records)} reads, {stats['edges']} edges, "
          f"{stats['substrings']} substrings -> {out}", file=sys.stderr)
    return 0


def cmd_oview(args) -> int:
    """Draw read overlaps from an ASQG file (StriDe/oview.cpp:73-124)."""
    from .graph import oview

    reads, omap = oview.parse_asqg(args.asqgfile)
    if args.id:
        roots = [args.id]
    else:
        roots = list(reads)
    for rid in roots:
        oview.draw_alignment(sys.stdout, rid, reads, omap,
                             args.default_padding, args.max_overhang)
    return 0


def cmd_subgraph(args) -> int:
    """Extract the neighborhood subgraph of a read
    (StriDe/subgraph.cpp:69-122 + addNeighborsToSubgraph BFS)."""
    from .graph import asqg
    from .graph.core import StringGraph

    g = asqg.load(args.asqgfile, 0, True)
    root = g.vertices.get(args.id)
    if root is None:
        print(f"Vertex {args.id} not found in the graph.", file=sys.stderr)
        return 1
    keep = {root.id}
    frontier = [root]
    for _ in range(args.size):
        nxt = []
        for v in frontier:
            for e in v.edges:
                w = e.end
                if w.id not in keep:
                    keep.add(w.id)
                    nxt.append(w)
        frontier = nxt
    sub = StringGraph()
    sub.min_overlap = g.min_overlap
    for vid in keep:
        sub.add_vertex(vid, g.vertices[vid].seq)
    seen = set()
    for vid in keep:
        for e in g.vertices[vid].edges:
            if e.end.id in keep:
                key = (id(e.twin)) if id(e.twin) < id(e) else id(e)
                if key in seen:
                    continue
                seen.add(key)
                from .graph.core import Overlap
                sub.add_edges_from_overlap(
                    Overlap((e.start.id, e.end.id), e.get_match()), 10**9)
    out = args.out or "subgraph.asqg.gz"
    asqg.write(out, sub)
    sub.write_dot(out + ".dot")
    print(f"subgraph: {len(keep)} vertices -> {out}", file=sys.stderr)
    return 0


def cmd_asmlong(args) -> int:
    """Long-read string-graph assembly (StriDe/asmlong.cpp:116-226): the
    corrected-long-read variant of assemble — containment removal,
    transitive reduction, unipath simplify, bubble/tip smoothing, then one
    overlap-length-difference chimera pass."""
    from .graph import asqg
    from .graph.visitors import (ContainRemoveVisitor, FastaVisitor,
                                 GraphStatsVisitor,
                                 RemoveByOverlapLenDiffVisitor,
                                 TransitiveReductionVisitor, contig_stats,
                                 graph_trim_and_smooth)

    max_chimera = args.max_chimera or 2 * args.insert_size
    print(f"Maximum Chimera Length : {max_chimera}", file=sys.stderr)
    print(f"Insert Size            : {args.insert_size}", file=sys.stderr)

    g = asqg.load(args.asqgfile, args.min_overlap, max_edges=args.max_edges)
    stats = GraphStatsVisitor()
    print("[Stats] Input graph:", file=sys.stderr)
    g.visit(stats)

    contain = ContainRemoveVisitor()
    while g.has_containment:
        g.visit(contain)
    g.visit(TransitiveReductionVisitor())
    g.simplify()
    print("[Stats] Simplified graph:", file=sys.stderr)
    g.visit(stats)

    # bubble/tip removal (asmlong.cpp:192-198)
    graph_trim_and_smooth(g, max_chimera, None, args.max_indel)

    # chimeric-edge pass from large vertices (asmlong.cpp:201-205)
    min_overlap_len = int(args.insert_size * args.min_overlap_ratio)
    if g.visit(RemoveByOverlapLenDiffVisitor(
            1600, min_overlap_len, args.insert_size // 10,
            island_protect=False)):
        pass
    graph_trim_and_smooth(g, max_chimera, None, args.max_indel)

    g.rename_vertices("")
    print("[Stats] Final graph:", file=sys.stderr)
    g.visit(stats)
    cs = contig_stats(g)
    print(f"contigs: {cs['contigs']} total {cs['total']} "
          f"n50 {cs['n50']} max {cs['max']}", file=sys.stderr)
    with open(args.out_prefix + "-contigs.fa", "w") as fh:
        g.visit(FastaVisitor(fh))
    asqg.write(args.out_prefix + "-graph.asqg.gz", g)
    g.write_dot("StriDe-graph.dot")
    return 0


def cmd_assemble(args) -> int:
    """String-graph assembly (StriDe/assemble.cpp:131-325)."""
    from .graph import asqg
    from .graph.visitors import (BothShortEdgesRemoveVisitor,
                                 ContainRemoveVisitor, FastaVisitor,
                                 GraphStatsVisitor, IllegalKmerEdgeVisitor,
                                 RemoveByOverlapLenDiffVisitor,
                                 TransitiveReductionVisitor, contig_stats,
                                 graph_trim_and_smooth)

    g = asqg.load(args.asqgfile, args.min_overlap, max_edges=args.max_edges)
    ix = _load_host_index(args.prefix) if args.prefix else None
    stats = GraphStatsVisitor()
    print("[Stats] Input graph:", file=sys.stderr)
    g.visit(stats)

    contain = ContainRemoveVisitor()
    while g.has_containment:
        g.visit(contain)
    g.visit(TransitiveReductionVisitor())
    g.simplify()
    print("[Stats] Simplified graph:", file=sys.stderr)
    g.visit(stats)

    if ix is not None:
        g.visit(IllegalKmerEdgeVisitor(ix, args.kmer_size, args.kmer_threshold,
                                       args.credible_overlap or 0))
        g.simplify()

    graph_trim_and_smooth(g, args.read_length, ix, args.max_indel)

    credible = args.credible_overlap or int(args.read_length * args.min_overlap_ratio)
    max_chimera = args.max_chimera or 2 * args.insert_size
    # chimera removal ladder (assemble.cpp:262-321)
    for threshold in range(2, args.kmer_threshold + 1):
        if ix is not None:
            if g.visit(BothShortEdgesRemoveVisitor(args.read_length, credible,
                                                   ix, args.kmer_size, threshold)):
                graph_trim_and_smooth(g, max_chimera, ix, args.max_indel)
    for vlen, olen in ((args.read_length, g.min_overlap),
                       (args.read_length, credible),
                       (args.insert_size, credible),
                       (max_chimera, credible)):
        if g.visit(BothShortEdgesRemoveVisitor(vlen, olen)):
            graph_trim_and_smooth(g, max_chimera, ix, args.max_indel)

    top = int(args.insert_size * args.min_overlap_ratio)
    step = max((top - credible) // 4, 1)
    for length in range(credible, top + 1, step):
        if g.visit(RemoveByOverlapLenDiffVisitor(1600, length, top + credible - length)):
            graph_trim_and_smooth(g, max_chimera, ix, args.max_indel)
    s3 = credible // 4
    while s3 <= credible // 2:
        if g.visit(RemoveByOverlapLenDiffVisitor(1600, 0, credible - s3)):
            graph_trim_and_smooth(g, max_chimera, ix, args.max_indel)
        s3 += s3
    if g.visit(BothShortEdgesRemoveVisitor(args.read_length + 100,
                                           int(args.read_length * 0.9))):
        graph_trim_and_smooth(g, max_chimera, ix, args.max_indel)

    if ix is not None and not args.no_pe:
        from .index import store
        from .graph.visitors import (FastaErosionVisitor,
                                     IslandCollectVisitor,
                                     JoinIslandVisitor,
                                     LowOverlapRatioEdgeSweepVisitor,
                                     RemoveEdgeByPEVisitor)

        ssa = store.load_sampled_sa(args.prefix, ix.bwt)
        # PE-support edge removal (assemble.cpp:312-319)
        for min_pe in (1,):
            if g.visit(RemoveEdgeByPEVisitor(ix, ssa, args.insert_size, 51,
                                             min_pe)):
                graph_trim_and_smooth(g, max_chimera, ix, args.max_indel)
        # small-vertex overlap-ratio sweep (assemble.cpp:326-331)
        for length in range(args.read_length, args.read_length + 101, 15):
            if g.visit(LowOverlapRatioEdgeSweepVisitor(
                    length, args.min_overlap_ratio,
                    int(length * args.min_overlap_ratio))):
                graph_trim_and_smooth(g, max_chimera, ix, args.max_indel)
        g.rename_vertices("")
        # island/tip re-join phase (assemble.cpp:337-360)
        g.visit(FastaErosionVisitor(ix.bwt, args.kmer_size,
                                    args.kmer_threshold, max_chimera))
        collect = IslandCollectVisitor(ix, ssa, args.insert_size, 51,
                                       max_chimera)
        g.visit(collect)
        g.visit(JoinIslandVisitor(100, 4000, args.kmer_size // 2 + 4,
                                  max_chimera, collect, ix, 3))
        graph_trim_and_smooth(g, max_chimera, ix, args.max_indel)

    print("[Stats] Final graph:", file=sys.stderr)
    g.visit(stats)
    with open(args.out_prefix + "-contigs.fa", "w") as fh:
        fv = FastaVisitor(fh)
        g.visit(fv)
    cs = contig_stats(g)
    print(f"contigs: {cs['contigs']}, total {cs['total']} bp, "
          f"N50 {cs['n50']}, max {cs['max']}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    # prog "lrsc", as in the JAX CLI: each subcommand's --help is the same text
    parser = argparse.ArgumentParser(prog="lrsc", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("index", help="build FM-index of a read set")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", default=None)
    p.add_argument("--ref-format", action="store_true",
                   help="also write reference-compatible .bwt/.rbwt binaries")
    p.add_argument("--pure-python", action="store_true",
                   help="force the numpy builder even if native/fmbuild exists")
    p.set_defaults(func=cmd_index)

    p = sub.add_parser("pbcorrect", help="PacBio self-correction")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-c", "--PBcoverage", type=int, default=90)
    p.add_argument("-e", "--error-rate", type=float, default=0.15, dest="error_rate")
    p.add_argument("-k", "--kmer-size", type=int, default=None, dest="kmer_size")
    p.add_argument("-n", "--next-target", type=int, default=1, dest="next_target")
    p.add_argument("-l", "--max-leaves", type=int, default=32, dest="max_leaves")
    p.add_argument("-i", "--idmer-length", type=int, default=9, dest="idmer_length")
    p.add_argument("-s", "--min-kmer-size", type=int, default=13, dest="min_kmer_size")
    p.add_argument("-g", "--genome", type=int, default=10, choices=(5, 10, 100))
    p.add_argument("-m", "--mode", type=int, default=None, choices=(0, 1, 2))
    p.add_argument("--split", action="store_true")
    p.add_argument("--nodp", action="store_true")
    p.add_argument("--onlyseed", action="store_true",
                   help="score seeds against barcode ground truth, no correction")
    p.add_argument("--debugseed", action="store_true",
                   help="dump per-read seed files under <output>/seed/ and "
                        "failed-gap traces under <output>/extend/ (.ext/.dp)")
    p.add_argument("--debugextend", action="store_true",
                   help="accepted for reference CLI parity; the per-leaf "
                        "extension trace it once gated is commented out in "
                        "the reference (PacBioSelfCorrectionProcess.cpp:86-97)"
                        " so it produces no output there or here")
    p.add_argument("-b", "--barcode", default=None)
    p.add_argument("--engine", choices=("host", "device"), default="device",
                   help="device: seed phase and walks batched on --device; "
                        "host: the single-thread numpy engine")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device engine runs (cpu: plain torch)")
    p.add_argument("--batch-reads", type=int, default=64, dest="batch_reads")
    p.add_argument("--walk-config", default=None, dest="walk_config",
                   help="device-engine walk shape override "
                        "G,MAXLEN,QMAX,WSCAN (tests/small runs)")
    p.add_argument("--num-processes", type=int, default=1,
                   dest="num_processes",
                   help="multi-process data parallelism: total process count")
    p.add_argument("--process-id", type=int, default=0, dest="process_id")
    p.add_argument("--coordinator", default="127.0.0.1:39181",
                   help="rendezvous address host:port (rank 0 hosts it)")
    p.set_defaults(func=cmd_pbcorrect)

    p = sub.add_parser("all", help="whole short-read pipeline in one run")
    p.add_argument("readsfile", nargs="+",
                   help="READS1 READS2 ... (pairs of files in pe-mode 1, "
                        "interleaved files in pe-mode 2)")
    p.add_argument("-r", "--read-length", type=int, required=True,
                   dest="read_length", help="median read length")
    p.add_argument("-i", "--insert-size", type=int, required=True,
                   dest="insert_size", help="median insert size")
    p.add_argument("-p", "--pe-mode", type=int, default=1, choices=(1, 2),
                   dest="pe_mode")
    p.add_argument("-k", "--kmer-size", type=int, default=31, dest="kmer_size")
    p.add_argument("-c", "--kmer-threshold", type=int, default=3,
                   dest="kmer_threshold")
    p.add_argument("-m", "--min-overlap", type=int, default=0,
                   dest="min_overlap",
                   help="minimum reliable overlap (default: 0.8 * read length)")
    p.add_argument("-d", "--dir", default=".",
                   help="working directory for stage artifacts")
    p.set_defaults(func=cmd_all)

    p = sub.add_parser("preprocess", help="quality filter/trim reads")
    p.add_argument("readsfile", nargs="+",
                   help="READS1 [READS2 ...]; pairs of files in --pe-mode 1")
    p.add_argument("-o", "--out", default="-")
    p.add_argument("-q", "--quality-trim", type=int, default=0, dest="quality_trim")
    p.add_argument("--hard-clip", type=int, default=0, dest="hard_clip")
    p.add_argument("-m", "--min-length", type=int, default=31, dest="min_length")
    p.add_argument("-f", "--quality-filter", type=int, default=-1, dest="quality_filter")
    p.add_argument("--no-quality", action="store_true", dest="no_quality")
    p.add_argument("--dust", action="store_true")
    p.add_argument("--dust-threshold", type=float, default=4.0, dest="dust_threshold")
    p.add_argument("--phred64", action="store_true")
    p.add_argument("-p", "--pe-mode", type=int, default=0, choices=(0, 1, 2),
                   dest="pe_mode",
                   help="0 unpaired; 1 pairs split across READS1/READS2 "
                        "(interleaved on output); 2 pairs interleaved per file")
    p.add_argument("--pe-orphans", default=None, dest="pe_orphans",
                   help="write the passing half of a failed pair here")
    p.add_argument("-s", "--sample", type=float, default=1.0,
                   help="random read/pair acceptance probability")
    p.add_argument("--suffix", default="", help="append SUFFIX to read IDs")
    p.add_argument("--permute-ambiguous", action="store_true",
                   dest="permute_ambiguous",
                   help="randomly resolve IUPAC codes instead of discarding")
    p.add_argument("--no-primer-check", action="store_true",
                   dest="no_primer_check",
                   help="disable the default Illumina primer screen")
    p.set_defaults(func=cmd_preprocess)

    p = sub.add_parser("correct", help="short-read kmer error correction")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-o", "--out", default="reads.ec.fa")
    p.add_argument("-k", "--kmer-size", type=int, default=31, dest="kmer_size")
    p.add_argument("-x", "--kmer-threshold", type=int, default=None, dest="kmer_threshold")
    p.add_argument("-r", "--kmer-rounds", type=int, default=10, dest="kmer_rounds")
    p.add_argument("-a", "--algorithm", choices=("kmer", "overlap", "hybrid"),
                   default="kmer")
    p.add_argument("-e", "--error-rate", type=float, default=0.04,
                   dest="error_rate")
    p.add_argument("-R", "--overlap-rounds", type=int, default=1,
                   dest="overlap_rounds")
    p.add_argument("--discard", default=None,
                   help="write QC-failed reads here instead of the main output")
    p.set_defaults(func=cmd_correct)

    p = sub.add_parser("fmwalk", help="PE-merge / validate FM-index walks")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-o", "--out", default="fmwalk.fa")
    p.add_argument("-a", "--algorithm",
                   choices=("merge", "validate", "kmerize", "hybrid"),
                   default="hybrid")
    p.add_argument("-m", "--min-overlap", type=int, default=31, dest="min_overlap")
    p.add_argument("-M", "--max-overlap", type=int, default=-1, dest="max_overlap")
    p.add_argument("-L", "--max-insert", type=int, default=500, dest="max_insert")
    p.add_argument("-l", "--max-leaves", type=int, default=32, dest="max_leaves")
    p.add_argument("-k", "--kmer-size", type=int, default=31, dest="kmer_size")
    p.add_argument("-x", "--kmer-threshold", type=int, default=3, dest="kmer_threshold")
    p.add_argument("--discard", default="kmerized.fa",
                   help="kmerized-piece output (empty string: main output)")
    p.set_defaults(func=cmd_fmwalk)

    p = sub.add_parser("filter", help="QC + duplicate removal")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-o", "--out", default="filter.pass.fa")
    p.add_argument("-d", "--discard", default=None)
    p.add_argument("-k", "--kmer-size", type=int, default=31, dest="kmer_size")
    p.add_argument("-x", "--kmer-threshold", type=int, default=3, dest="kmer_threshold")
    p.add_argument("--no-duplicate-check", action="store_true")
    p.add_argument("--no-kmer-check", action="store_true")
    p.add_argument("--substring-only", action="store_true")
    p.set_defaults(func=cmd_filter)

    p = sub.add_parser("merge", help="FM-merge unambiguous reads into unitigs")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-o", "--out", default="merged.fa")
    p.add_argument("-m", "--min-overlap", type=int, default=45, dest="min_overlap")
    p.set_defaults(func=cmd_merge)

    p = sub.add_parser("overlap", help="all-vs-all read overlap -> ASQG")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-o", "--out", default=None)
    p.add_argument("-m", "--min-overlap", type=int, default=31, dest="min_overlap")
    p.add_argument("--exact", action="store_true",
                   help="emit only irreducible overlaps (reference default)")
    p.add_argument("-x", "--exhaustive", action="store_true",
                   help="emit all overlaps including transitive edges")
    p.add_argument("-e", "--error-rate", type=float, default=-1.0,
                   dest="error_rate",
                   help="max error rate for inexact overlap (default: exact)")
    p.add_argument("-l", "--maxindel", type=int, default=0,
                   help="max indels during inexact overlap computation")
    p.set_defaults(func=cmd_overlap)

    p = sub.add_parser("assemble", help="string-graph contig assembly")
    p.add_argument("asqgfile")
    p.add_argument("-p", "--prefix", default=None,
                   help="FM-index prefix (for kmer-based edge checks)")
    p.add_argument("-o", "--out-prefix", default="StriDe", dest="out_prefix")
    p.add_argument("-m", "--min-overlap", type=int, default=30, dest="min_overlap")
    p.add_argument("-k", "--kmer-size", type=int, default=31, dest="kmer_size")
    p.add_argument("-t", "--kmer-threshold", type=int, default=3, dest="kmer_threshold")
    p.add_argument("-r", "--read-length", type=int, default=100, dest="read_length")
    p.add_argument("-i", "--insert-size", type=int, default=400, dest="insert_size")
    p.add_argument("-T", "--min-overlap-ratio", type=float, default=0.8,
                   dest="min_overlap_ratio")
    p.add_argument("-x", "--max-chimera", type=int, default=0, dest="max_chimera")
    p.add_argument("-c", "--credible-overlap", type=int, default=0,
                   dest="credible_overlap")
    p.add_argument("--max-edges", type=int, default=2000, dest="max_edges")
    p.add_argument("--max-indel", type=int, default=9, dest="max_indel")
    p.add_argument("--no-pe", action="store_true", dest="no_pe",
                   help="skip the PE-support and island-join phases "
                        "(for non-paired read sets)")
    p.set_defaults(func=cmd_assemble)

    p = sub.add_parser("asmlong", help="long-read string-graph assembly")
    p.add_argument("asqgfile")
    p.add_argument("-p", "--prefix", default=None)
    p.add_argument("-o", "--out-prefix", default="StriDe", dest="out_prefix")
    p.add_argument("-m", "--min-overlap", type=int, default=30, dest="min_overlap")
    p.add_argument("-i", "--insert-size", type=int, required=True, dest="insert_size")
    p.add_argument("-x", "--max-chimera", type=int, default=0, dest="max_chimera")
    p.add_argument("-T", "--min-overlap-ratio", type=float, default=0.8,
                   dest="min_overlap_ratio")
    p.add_argument("--max-edges", type=int, default=512, dest="max_edges")
    p.add_argument("--max-indel", type=int, default=100, dest="max_indel")
    p.set_defaults(func=cmd_asmlong)

    p = sub.add_parser("oview", help="draw read overlaps from an ASQG file")
    p.add_argument("asqgfile")
    p.add_argument("-i", "--id", default=None)
    p.add_argument("-m", "--max-overhang", type=int, default=20,
                   dest="max_overhang")
    p.add_argument("-d", "--default-padding", type=int, default=20,
                   dest="default_padding")
    p.set_defaults(func=cmd_oview)

    p = sub.add_parser("subgraph", help="extract a neighborhood subgraph")
    p.add_argument("id")
    p.add_argument("asqgfile")
    p.add_argument("-s", "--size", type=int, default=5)
    p.add_argument("-o", "--out", default=None)
    p.set_defaults(func=cmd_subgraph)

    p = sub.add_parser("grep", help="locate a pattern's reads via the index")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True)
    p.set_defaults(func=cmd_grep)

    p = sub.add_parser("pbhc", help="PacBio hybrid correction (short-read index)")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True, help="short-read index prefix")
    p.add_argument("-f", "--PBprefix", default=None, help="PacBio index prefix")
    p.add_argument("-o", "--outfile", default=None)
    p.add_argument("-r", "--readlen", type=int, default=100)
    p.add_argument("-c", "--coverage", type=int, default=-1,
                   help="short-read coverage")
    p.add_argument("-C", "--PBcoverage", type=int, default=60)
    p.add_argument("-k", "--min-seed-length", type=int, default=21,
                   dest="min_seed_length")
    p.add_argument("--kmer-size", type=int, default=31, dest="kmer_size")
    p.add_argument("-x", "--fmw-threshold", type=int, default=3,
                   dest="fmw_threshold")
    p.add_argument("-m", "--min-overlap", type=int, default=-1, dest="min_overlap")
    p.add_argument("-M", "--max-overlap", type=int, default=-1, dest="max_overlap")
    p.add_argument("-L", "--max-leaves", type=int, default=256, dest="max_leaves")
    p.add_argument("--PBkmer-length", type=int, default=17, dest="PBkmer_length")
    p.add_argument("--PBsearch-depth", type=int, default=1000,
                   dest="PBsearch_depth")
    p.set_defaults(func=cmd_pbhc)

    p = sub.add_parser("kmerfreq", help="interactive k-mer frequency probe")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-c", "--PBcoverage", type=int, default=90)
    p.set_defaults(func=cmd_kmerfreq)

    p = sub.add_parser(
        "kmercheck",
        help="correct-vs-error kmer distributions vs a barcode ground truth")
    p.add_argument("readsfile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-o", "--directory", required=True)
    p.add_argument("-b", "--barcode", required=True)
    p.add_argument("-c", "--coverage", type=int, default=90)
    p.add_argument("-l", "--lower", type=int, default=15)
    p.add_argument("-u", "--upper", type=int, default=35)
    p.add_argument("-s", "--step", type=int, default=1)
    p.set_defaults(func=cmd_kmercheck)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
