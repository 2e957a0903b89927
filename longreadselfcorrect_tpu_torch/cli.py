"""Command line interface of the torch port (subset of the stride surface).

  index       build BWT/RBWT of a read set          (StriDe/index.cpp)
  pbcorrect   PacBio self-correction                (StriDe/PacBioSelfCorrection.cpp)

pbcorrect's default is the device engine on CUDA: the seed phase, the
FM-extension walks and the MSA/DP fallback's two loops (LF extraction and
the banded DP fill) run as the CUDA kernels of ops/; the DP backtrack and
the consensus stay on the host.  There is no fallback: without a GPU, pass
--device cpu (the plain torch versions) or --engine host (the numpy
engine).
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
    BatchedSelfCorrector with its index on --device."""
    from .core.correct import SelfCorrector
    from .index.pack import open_index

    if args.engine == "host":
        return SelfCorrector(open_index(args.prefix, device=None)[0], params)
    import torch

    from .core.batch_correct import BatchedSelfCorrector

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pbcorrect --device cuda: no CUDA device is available "
                           "(use --device cpu or --engine host)")
    hix, dix = open_index(args.prefix, device=args.device)
    return BatchedSelfCorrector(hix, dix, params)


def cmd_pbcorrect(args) -> int:
    from .core.correct import CorrectionParams
    from .io import fasta

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
        debug_seed=args.debugseed,
        directory=args.output,
    )
    corrector = make_corrector(args, params)
    use_device = args.engine == "device"
    os.makedirs(args.output, exist_ok=True)
    # threshold-table dump: the reference writes it whenever the output
    # directory exists (KmerThreshold::initialize -> dtor, KmerThreshold.cpp:
    # 33-41,50; StriDe/PacBioSelfCorrection.cpp:231)
    corrector.thresh.write_table(os.path.join(args.output, "threshold-table"))

    totals = dict(
        reads_len=0, corrected_len=0, seed_num=0, walk_num=0, high_error=0,
        exceed_depth=0, exceed_leave=0, fm=0, dp=0, seed_dis=0,
        t_seed=0.0, t_fm=0.0, t_dp=0.0,
    )
    t0 = time.time()
    n = 0

    def work_records():
        for rec in fasta.read_seqs(args.readsfile):
            yield rec.id, rec.seq

    def result_stream():
        if use_device:
            def batches():
                batch = []
                for rid, seq in work_records():
                    batch.append((rid, seq))
                    if len(batch) == args.batch_reads:
                        yield batch
                        batch = []
                if batch:
                    yield batch

            # batch k+1's device seed phase overlaps batch k's host workflow
            all_batches = list(batches())
            for batch, results in zip(all_batches,
                                      corrector.process_stream(all_batches)):
                yield from zip(batch, results)
        else:
            for rid, seq in work_records():
                yield (rid, seq), corrector.process(rid, seq)

    correct_path = os.path.join(args.output, "correct.fa")
    discard_path = os.path.join(args.output, "discard.fa")
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
    p.add_argument("--debugseed", action="store_true",
                   help="dump per-read seed files under <output>/seed/ and "
                        "failed-gap traces under <output>/extend/ (.ext/.dp)")
    p.add_argument("--engine", choices=("host", "device"), default="device",
                   help="device: seed phase and walks batched on --device; "
                        "host: the single-thread numpy engine")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device engine runs (cpu: plain torch)")
    p.add_argument("--batch-reads", type=int, default=64, dest="batch_reads")
    p.set_defaults(func=cmd_pbcorrect)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
