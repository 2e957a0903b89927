"""Per-read PacBio self-correction workflow.

Re-implementation of PacBio/PacBioSelfCorrectionProcess.{h,cpp}: seed search,
then per adjacent-seed-pair FM-extension with next-target lookahead, MSA
fallback, raw-subsequence fallback, and the failure taxonomy counters.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

from . import alphabet as ab
from . import msa, seeds as seedmod
from .extend import FMExtendParams, HostExtendEngine
from .seeds import ProbeParams, Seed
from .threshold import KmerThreshold


@dataclass
class CorrectionParams:
    """PacBioSelfCorrectionParameters (PacBioSelfCorrectionProcess.h) with the
    reference CLI's derived defaults (StriDe/PacBioSelfCorrection.cpp:195-231)."""

    pb_coverage: int = 90
    error_rate: float = 0.15
    next_target: int = 1
    max_leaves: int = 32
    idmer_len: int = 9
    min_kmer_len: int = 13
    start_kmer_len: int = 19
    genome: int = 10           # 5 / 10 / 100 (Mbp)
    mode: int = 1
    manual: bool = False
    adjust: bool = False       # -k/-u/-r given explicitly
    split: bool = False
    no_dp: bool = False
    only_seed: bool = False   # --onlyseed (score seeds vs barcode, no correction)
    debug_seed: bool = False  # --debugseed (dump per-read seed files)
    directory: str = ""       # dump directory (reference opt::directory)

    def derived(self) -> tuple[ProbeParams, FMExtendParams, int]:
        """Genome-size auto-offsets + parameter structs + min SA threshold."""
        order = {5: 0, 10: 1, 100: 2}[self.genome]
        start_kmer_len = self.start_kmer_len
        offset = [0, 0, 0]
        if not self.adjust:
            start_kmer_len = (17, 19, 21)[order]
            offset[1] = 2 * min(max(self.pb_coverage // 30 - 1, 0), order + 1)
            offset[2] = -2 * (order + 1)
        pool = sorted({5, 9, 19} | {start_kmer_len + o for o in offset})
        probe = ProbeParams(
            start_kmer_len=start_kmer_len,
            pb_coverage=self.pb_coverage,
            mode=self.mode,
            offset=tuple(offset),
            pool=tuple(pool),
            manual=self.manual,
            debug_seed=self.debug_seed,
            directory=self.directory,
        )
        fm = FMExtendParams(
            idmer_length=self.idmer_len,
            max_leaves=self.max_leaves,
            min_kmer_length=self.min_kmer_len,
            pb_coverage=self.pb_coverage,
            error_rate=self.error_rate,
        )
        min_sa = (self.pb_coverage // 60) * 3 if self.pb_coverage > 60 else 3
        return probe, fm, start_kmer_len


@dataclass
class CorrectionResult:
    """PacBioSelfCorrectionResult counters."""

    read_id: str = ""
    merge: bool = False
    corrected_strs: list[str] = field(default_factory=list)
    total_reads_len: int = 0
    corrected_len: int = 0
    total_seed_num: int = 0
    total_walk_num: int = 0
    high_error_num: int = 0
    exceed_depth_num: int = 0
    exceed_leave_num: int = 0
    fm_num: int = 0
    dp_num: int = 0
    seed_dis: int = 0
    # per-phase wall times (result.Timer_Seed/FM/DP,
    # PacBioSelfCorrectionProcess.cpp:40,191,234)
    timer_seed: float = 0.0
    timer_fm: float = 0.0
    timer_dp: float = 0.0
    seeds: list | None = None  # kept for --onlyseed scoring / --debugseed dumps


class SelfCorrector:
    """One-process equivalent of PacBioSelfCorrectionProcess."""

    def __init__(self, ix, params: CorrectionParams, thresh: KmerThreshold | None = None):
        self.ix = ix
        self.params = params
        self.probe_params, self.fm_params, self.start_kmer_len = params.derived()
        # KmerThreshold::Instance().initialize(-1, 50, cov)
        self.thresh = thresh or KmerThreshold(-1, 50, params.pb_coverage)

    # ------------------------------------------------------------------
    def process(self, read_id: str, read_seq: str) -> CorrectionResult:
        import time as _time

        result = CorrectionResult(read_id=read_id)
        _t0 = _time.time()
        seeds = seedmod.search_seeds(read_seq, self.ix, self.probe_params,
                                     self.thresh, read_id=read_id)
        result.timer_seed = _time.time() - _t0
        result.total_seed_num = len(seeds)
        self._dump_seeds(read_id, seeds)
        if self.params.only_seed:
            result.seeds = seeds
            return result
        pieces = self._init_correct(read_seq, seeds, result)
        result.merge = bool(pieces)
        result.total_reads_len = len(read_seq)
        result.corrected_strs = [p.seed_str for p in pieces]
        return result

    def _dump_seeds(self, read_id: str, seeds) -> None:
        """--debugseed seed dump (LongReadProbe.cpp:109-114, format
        SeedFeature.cpp:11-19)."""
        if not self.params.debug_seed:
            return
        import os

        d = os.path.join(self.params.directory or ".", "seed")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, read_id + ".seed"), "w") as fh:
            for s in seeds:
                fh.write(f"{s.seed_str}\t{s.max_fixed_mer_freq}\t"
                         f"{s.seed_start_pos}\t{'Yes' if s.is_repeat else 'No'}\n")

    # ------------------------------------------------------------------
    def _init_correct(self, read_seq: str, seeds: list[Seed],
                      result: CorrectionResult) -> list[Seed]:
        """initCorrect (PacBioSelfCorrectionProcess.cpp:56-157)."""
        if len(seeds) < 2:
            return []
        ext_w = dp_w = None
        if self.params.debug_seed:
            # per-read failed-gap dumps (PacBioSelfCorrectionProcess.cpp:
            # 64-74,130-131,139-140): extend/<read>.ext records FM failures
            # (+4-coded type), extend/<read>.dp records MSA failures
            import os

            d = os.path.join(self.params.directory or ".", "extend")
            os.makedirs(d, exist_ok=True)
            ext_w = open(os.path.join(d, result.read_id + ".ext"), "w")
            dp_w = open(os.path.join(d, result.read_id + ".dp"), "w")
        pieces = [copy.copy(seeds[0])]
        i = 1
        while i < len(seeds):
            code = 0
            first_type = 0
            source = pieces[-1]
            out = ""
            for nxt in range(self.params.next_target):
                if i + nxt >= len(seeds):
                    break
                target = seeds[i + nxt]
                code, out = self._correct_by_fm_extension(source, target, read_seq, result)
                if nxt == 0:
                    first_type = code
                if code > 0:
                    result.total_walk_num += 1
                    source.append(out, target)
                    i += nxt
                    break
            if code <= 0:
                target = seeds[i]
                if first_type == -1:
                    result.high_error_num += 1
                elif first_type == -2:
                    result.exceed_depth_num += 1
                elif first_type == -3:
                    result.exceed_leave_num += 1
                if ext_w is not None:
                    ext_w.write(f"{source.seed_start_pos}\t"
                                f"{target.seed_start_pos}\t{first_type + 4}\n")
                result.total_walk_num += 1
                ok, out = self._correct_by_msa(source, target, read_seq, result)
                if ok:
                    source.append(out, target)
                else:
                    if dp_w is not None:
                        dp_w.write(f"{source.seed_start_pos}\t"
                                   f"{target.seed_start_pos}\n")
                    if self.params.split:
                        pieces.append(copy.copy(target))
                    else:
                        merged = read_seq[source.seed_end_pos + 1 : target.seed_end_pos + 1]
                        source.append(merged, target)
                    result.corrected_len += len(target.seed_str)
            i += 1
        if ext_w is not None:
            ext_w.close()
            dp_w.close()
        return pieces

    # ------------------------------------------------------------------
    def _gap_setup(self, source: Seed, target: Seed, read_seq: str):
        interval = target.seed_start_pos - source.seed_end_pos - 1
        extend_kmer_size = min(source.end_best_kmer_size, target.start_best_kmer_size) - 2
        if source.is_repeat or target.is_repeat:
            extend_kmer_size = min(source.seed_len, target.seed_len)
            extend_kmer_size = min(extend_kmer_size, self.start_kmer_len + 2)
        src = source.seed_str[source.seed_len - extend_kmer_size:]
        trg = target.seed_str
        if interval >= 0:
            path = read_seq[source.seed_end_pos + 1 : source.seed_end_pos + 1 + interval]
        else:
            # substr(pos, negative-as-size_t) in C++ yields the whole tail
            path = read_seq[source.seed_end_pos + 1:]
        return interval, extend_kmer_size, src, trg, path

    def _correct_by_fm_extension(self, source: Seed, target: Seed, read_seq: str,
                                 result: CorrectionResult):
        """correctByFMExtension (PacBioSelfCorrectionProcess.cpp:159-206)."""
        interval, ek, src, trg, path = self._gap_setup(source, target, read_seq)
        min_sa = (self.params.pb_coverage // 60) * 3 if self.params.pb_coverage > 60 else 3
        is_from_r_to_u = source.is_repeat and not target.is_repeat
        if is_from_r_to_u:
            src, trg = trg, src
            src = ab.revcomp_str(src)
            trg = ab.revcomp_str(trg)
            path = ab.revcomp_str(path)
        import time as _time

        _t0 = _time.time()
        engine = HostExtendEngine(
            self.ix, src, path, trg, interval, ek, ek + 2, self.fm_params, min_sa,
        )
        code, walk = engine.extend()
        result.timer_fm += _time.time() - _t0
        if code < 0:
            return code, ""
        merged = walk.merged_seq
        if is_from_r_to_u:
            merged = ab.revcomp_str(merged)
            merged += ab.revcomp_str(src)[ek:]
        out = merged[ek:]
        result.corrected_len += len(out)
        result.seed_dis += interval
        result.fm_num += 1
        return code, out

    def _correct_by_msa(self, source: Seed, target: Seed, read_seq: str,
                        result: CorrectionResult):
        """correctByMSAlignment (PacBioSelfCorrectionProcess.cpp:208-245)."""
        if self.params.no_dp:
            return False, ""
        import time as _time

        _t0 = _time.time()
        try:
            return self._correct_by_msa_inner(source, target, read_seq, result)
        finally:
            result.timer_dp += _time.time() - _t0

    def _correct_by_msa_inner(self, source: Seed, target: Seed, read_seq: str,
                              result: CorrectionResult):
        interval, ek, src, trg, path = self._gap_setup(source, target, read_seq)
        query = src + path + trg
        identity = 0.65
        total_max = source.max_fixed_mer_freq + target.max_fixed_mer_freq
        identity += 0.05 if total_max > 50 else 0
        identity += 0.05 if total_max > 100 else 0
        min_call_coverage = int(total_max * 0.4) if total_max > 50 else 15
        ma = msa.build_multiple_alignment(
            query, ek, ek, len(query) // 10, identity, self.params.pb_coverage,
            self.ix,
        )
        if ma.num_rows() <= 3:
            return False, ""
        out = ma.calculate_base_consensus(min_call_coverage, -1)
        out = out[ek:]
        result.corrected_len += len(out)
        result.seed_dis += interval
        result.dp_num += 1
        return True, out
