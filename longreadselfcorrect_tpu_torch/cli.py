"""Command line interface of the torch port (subset of the stride surface).

  index       build BWT/RBWT of a read set          (StriDe/index.cpp)
  pbcorrect   PacBio self-correction                (StriDe/PacBioSelfCorrection.cpp)

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lrsc-torch", description=__doc__,
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

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
