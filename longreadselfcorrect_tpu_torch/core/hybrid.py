"""PacBio hybrid correction (`stride pbhc`) — reference-fidelity engine.

Corrects PacBio reads using a short-read FM-index plus the PacBio reads'
own FM-index:

* seeding: `seedingByDynamicKmer_v3` (PacBioHybridCorrectionProcess.cpp:313-
  440) — dynamic k-mer growth from k=21 under the quadratic coverage-scaled
  threshold, repeat-seed boundary trimming (trimRepeatSeed, :1133-1215), and
  PB-index seed rescue across >PBSearchDepth gaps (seedingByPacBio_v2,
  :497-580);
* per seed pair: `extendBetweenSeeds` (:872-1065) — SAIntervalPBHybridCTree
  walks on the short-read index with iterative minOverlap reduction and
  forward/reverse agreement, then the ShortReadOverlapTree retry
  (ShortReadOverlapTree.cpp), then the PB-index MSA fallback (:1040-1062);
* candidate ranking by the exact stdaln aln_param_pacbio global alignment
  score (core/stdaln.py, score-exact vs the reference binary).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import alphabet as ab
from .itree import ITree
from .stdaln import aln_score_pacbio


def _size(lo: int, hi: int) -> int:
    return hi - lo + 1


def _valid(lo: int, hi: int) -> bool:
    return lo <= hi


@dataclass
class HybridParams:
    """ecParams of PacBioHybridCorrection.cpp:68-90,199-216."""

    kmer_length: int = 31          # -k is minSeedLength in the driver; this
    min_kmer_length: int = 21      # pair mirrors ecParams.{kmerLength,minKmerLength}
    max_leaves: int = 256
    min_overlap: int = 81          # readLen*0.8+1
    max_overlap: int = 91          # readLen*0.9+1
    coverage: int = 100            # short-read coverage
    fmw_kmer_threshold: int = 3    # -x
    pb_kmer_length: int = 17
    pb_coverage: int = 60
    pb_search_depth: int = 1000


class HSeed:
    """SeedFeature under pbhc's legacy ctor (SeedFeature.cpp:83-105):
    freq bounds repeatCutoff=PBcoverage/2 and its half; best-k starts at the
    dynamic kmer size.  estimateBestKmerSize counts SINGLE-strand suffix/
    prefix occurrences on the PB index (SeedFeature.cpp:49-78)."""

    __slots__ = ("seed_str", "seed_len", "seed_start_pos", "seed_end_pos",
                 "is_repeat", "is_pb_seed", "is_next_repeat",
                 "start_best_kmer_size", "end_best_kmer_size",
                 "min_kmer_size", "freq_upper", "freq_lower")

    def __init__(self, start_pos: int, seed_str: str, repeat: bool,
                 kmer_size: int, repeat_cutoff: int):
        self.seed_str = seed_str
        self.seed_len = len(seed_str)
        self.seed_start_pos = start_pos
        self.seed_end_pos = start_pos + self.seed_len - 1
        self.is_repeat = repeat
        self.is_pb_seed = False
        self.is_next_repeat = False
        self.min_kmer_size = kmer_size
        self.start_best_kmer_size = kmer_size
        self.end_best_kmer_size = kmer_size
        self.freq_upper = int(repeat_cutoff)
        self.freq_lower = int(repeat_cutoff) >> 1

    def append(self, extended: str) -> None:
        """legacy append (SeedFeature.h:50-56)."""
        self.seed_str += extended
        self.seed_len += len(extended)
        self.seed_start_pos += len(extended)
        self.seed_end_pos += len(extended)

    # -- estimateBestKmerSize ------------------------------------------------
    def _count_suffix(self, hix, word_codes: np.ndarray, use_rbwt: bool) -> int:
        fm = hix.rbwt if use_rbwt else hix.bwt
        lo, hi = fm.find_interval(word_codes)
        return max(int(hi) - int(lo) + 1, 0)

    def _modify(self, hix, pole: bool) -> None:
        k = self.start_best_kmer_size if pole else self.end_best_kmer_size
        seed = self.seed_str[::-1] if pole else self.seed_str
        codes = ab.encode(seed)

        def freq_of(kk: int) -> int:
            return self._count_suffix(hix, codes[self.seed_len - kk:], pole)

        kf = freq_of(k)
        if kf > self.freq_upper:
            bit = 1
        elif kf < self.freq_lower:
            bit = -1
        else:
            return
        freq_bound = self.freq_upper if bit > 0 else self.freq_lower
        cors_bound = self.freq_lower if bit > 0 else self.freq_upper
        # the reference's size bounds are uninitialised in the legacy ctor
        # (UB); emulate the primary ctor's intent: [kmer_size, seed_len]
        size_bound = self.seed_len if bit > 0 else self.min_kmer_size
        while (bit ^ kf) > (bit ^ freq_bound) and (bit ^ k) < (bit ^ size_bound):
            k += bit
            kf = freq_of(k)
        if (bit ^ kf) < (bit ^ cors_bound):
            k -= bit
            kf = freq_of(k)
        if pole:
            self.start_best_kmer_size = k
        else:
            self.end_best_kmer_size = k

    def estimate_best_kmer_size(self, pb_hix) -> None:
        self._modify(pb_hix, True)
        self._modify(pb_hix, False)


def is_low_complexity(seq: str, ratio_threshold: float) -> bool:
    """isLowComplexity (:1100-1130): any base ratio >= threshold OR any
    base entirely absent."""
    n = len(seq)
    counts = [seq.count(c) for c in "ACGT"]
    return any(c / n >= ratio_threshold for c in counts) or any(
        c == 0 for c in counts)


# ---------------------------------------------------------------------------
# walk leaves
# ---------------------------------------------------------------------------

class _Leaf:
    __slots__ = ("full", "f_lo", "f_hi", "r_lo", "r_hi", "kmer_count",
                 # ShortReadOverlapTree extras (SAIOverlapNode2)
                 "last_overlap_len", "curr_overlap_len", "query_overlap_len",
                 "last_seed_idx", "init_seed_idx", "total_seeds",
                 "num_errors", "last_seed_idx_offset", "num_redeem")

    def __init__(self, full):
        self.full = full
        self.kmer_count = 0
        self.num_errors = 0
        self.last_seed_idx_offset = 0
        self.num_redeem = 0.0

    def clone(self, ch: str) -> "_Leaf":
        c = _Leaf(self.full + ch)
        c.kmer_count = 0
        for name in ("last_overlap_len", "curr_overlap_len",
                     "query_overlap_len", "last_seed_idx", "init_seed_idx",
                     "total_seeds", "num_errors", "last_seed_idx_offset",
                     "num_redeem"):
            try:
                setattr(c, name, getattr(self, name))
            except AttributeError:
                pass
        return c


def _find_fwd_rvc(hix, word: str):
    """(fwdInterval, rvcInterval) of findInterval(pRBWT, reverse(w)) and
    findInterval(pBWT, revcomp(w))."""
    codes = ab.encode(word)
    f_lo, f_hi = hix.rbwt.find_interval(codes[::-1].copy())
    r_lo, r_hi = hix.bwt.find_interval(ab.reverse_complement(codes))
    return int(f_lo), int(f_hi), int(r_lo), int(r_hi)


def _probe_leaves(hix, leaves, threshold):
    """getFMIndexExtensions for all leaves, vectorised
    (SAIPBHybridCTree.cpp:355-400)."""
    n = len(leaves)
    f_lo = np.array([l.f_lo for l in leaves])[:, None].repeat(4, 1)
    f_hi = np.array([l.f_hi for l in leaves])[:, None].repeat(4, 1)
    r_lo = np.array([l.r_lo for l in leaves])[:, None].repeat(4, 1)
    r_hi = np.array([l.r_hi for l in leaves])[:, None].repeat(4, 1)
    syms = np.arange(1, 5)[None, :].repeat(n, 0)
    f_valid = f_lo <= f_hi
    nf = hix.rbwt.update_interval(f_lo, f_hi, syms)
    f_lo2 = np.where(f_valid, nf[0], f_lo)
    f_hi2 = np.where(f_valid, nf[1], f_hi)
    r_valid = r_lo <= r_hi
    nr = hix.bwt.update_interval(r_lo, r_hi, 5 - syms)
    r_lo2 = np.where(r_valid, nr[0], r_lo)
    r_hi2 = np.where(r_valid, nr[1], r_hi)
    f_ok = f_lo2 <= f_hi2
    r_ok = r_lo2 <= r_hi2
    bcount = np.where(f_ok, f_hi2 - f_lo2 + 1, 0) + np.where(r_ok, r_hi2 - r_lo2 + 1, 0)
    keep = bcount >= threshold
    return f_lo2, f_hi2, r_lo2, r_hi2, f_ok, r_ok, bcount, keep


class PBHybridCTree:
    """SAIntervalPBHybridCTree (SAIPBHybridCTree.cpp): two-seed walk on the
    short-read index with constant threshold and maxOverlap refinement."""

    def __init__(self, hix, source_seed: str, target_seed: str,
                 str_between: str, dis: int, min_overlap: int,
                 max_overlap: int, max_leaves: int, sa_threshold: int,
                 coverage: int):
        self.ix = hix
        self.source = source_seed
        self.target = target_seed
        self.between = str_between
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.max_leaves = max_leaves
        self.threshold = sa_threshold
        self.coverage = coverage

        root = _Leaf(source_seed)
        beginning = source_seed[len(source_seed) - min_overlap:]
        root.f_lo, root.f_hi, root.r_lo, root.r_hi = _find_fwd_rvc(hix, beginning)
        self.leaves = [root]
        self.cur_len = len(source_seed)
        self.cur_k = min_overlap

        ending = target_seed[:min_overlap]
        self.max_length = int(1.1 * (dis + 10)) + len(ending) + self.cur_len
        self.min_length = int(0.9 * (dis - 30) + len(ending) + self.cur_len)
        tf = _find_fwd_rvc(hix, ending)
        self.term_f = (tf[0], tf[1])
        self.term_r = (tf[2], tf[3])
        self.beg_size = max(root.f_hi - root.f_lo + 1, 0) + max(root.r_hi - root.r_lo + 1, 0)
        self.term_size = max(tf[1] - tf[0] + 1, 0) + max(tf[3] - tf[2] + 1, 0)

    # ------------------------------------------------------------------
    def _attempt(self):
        new = []
        lv = self.leaves
        if not lv:
            return new
        f_lo, f_hi, r_lo, r_hi, f_ok, r_ok, bcount, keep = _probe_leaves(
            self.ix, lv, self.threshold)
        for i, leaf in enumerate(lv):
            exts = np.flatnonzero(keep[i])
            if len(exts) == 1:
                b = int(exts[0])
                leaf.full += "ACGT"[b]
                leaf.f_lo, leaf.f_hi = int(f_lo[i, b]), int(f_hi[i, b])
                leaf.r_lo, leaf.r_hi = int(r_lo[i, b]), int(r_hi[i, b])
                if leaf.f_lo <= leaf.f_hi:
                    leaf.kmer_count += leaf.f_hi - leaf.f_lo + 1
                if leaf.r_lo <= leaf.r_hi:
                    leaf.kmer_count += leaf.r_hi - leaf.r_lo + 1
                new.append(leaf)
            elif len(exts) > 1:
                for b in exts:
                    c = leaf.clone("ACGT"[int(b)])
                    c.f_lo, c.f_hi = int(f_lo[i, b]), int(f_hi[i, b])
                    c.r_lo, c.r_hi = int(r_lo[i, b]), int(r_hi[i, b])
                    c.kmer_count = leaf.kmer_count
                    if c.f_lo <= c.f_hi:
                        c.kmer_count += c.f_hi - c.f_lo + 1
                    if c.r_lo <= c.r_hi:
                        c.kmer_count += c.r_hi - c.r_lo + 1
                    new.append(c)
        return new

    def _refine(self, new_k: int) -> None:
        for leaf in self.leaves:
            suffix = leaf.full[len(leaf.full) - new_k:]
            leaf.f_lo, leaf.f_hi, leaf.r_lo, leaf.r_hi = _find_fwd_rvc(
                self.ix, suffix)
        self.cur_k = new_k

    def _extend_leaves(self) -> None:
        new = self._attempt()
        if self.cur_k >= self.max_overlap:
            if (self.beg_size >= self.coverage * 0.8
                    or self.term_size >= self.coverage * 0.8):
                self._refine(81)
            else:
                self._refine(self.min_overlap)
        if not new:
            self._refine(self.min_overlap)
            new = self._attempt()
        if new:
            self.cur_len += 1
            self.cur_k += 1
        self.leaves = new

    def _terminated(self, results) -> None:
        for leaf in self.leaves:
            fv = leaf.f_lo <= leaf.f_hi
            rv = leaf.r_lo <= leaf.r_hi
            if (fv and leaf.f_lo >= self.term_f[0] and leaf.f_hi <= self.term_f[1]) or (
                    rv and leaf.r_lo >= self.term_r[0] and leaf.r_hi <= self.term_r[1]):
                results.append((leaf.full, leaf.kmer_count))

    def merge_two_seeds(self):
        """mergeTwoSeeds -> (code, merged_seq, aln_score)."""
        results = []
        while self.leaves and len(self.leaves) <= self.max_leaves and \
                self.cur_len <= self.max_length:
            self._extend_leaves()
            if self.min_length >= 0 and self.cur_len >= self.min_length:
                self._terminated(results)
        if results:
            return self._best_path(results)
        if not self.leaves:
            return -1, "", -100
        if self.cur_len > self.max_length:
            return -2, "", -100
        if len(self.leaves) > self.max_leaves:
            return -3, "", -100
        return -4, "", -100

    def _best_path(self, results):
        """findTheBestPath (SAIPBHybridCTree.cpp:176-220)."""
        best_score = -100
        best = ""
        for thread, _cov in results:
            if len(self.target) > self.min_overlap:
                cand = thread + self.target[self.min_overlap:]
            else:
                cand = thread
            src_len = len(self.source)
            path = cand[src_len - 10:][: len(cand) - src_len - len(self.target) + 20]
            score = aln_score_pacbio(self.between, path)
            if best_score < score:
                best_score = score
                best = cand
        if best:
            return 1, best, best_score
        return -4, "", -100


class ShortReadOverlapTree:
    """ShortReadOverlapTree (ShortReadOverlapTree.cpp): the seed-supported
    retry walk with error-rate pruning and a best-100 cap."""

    SEED_SIZE = 11

    def __init__(self, hix, source_seed: str, between: str, target_seed: str,
                 dis: int, min_overlap: int, max_overlap: int,
                 sa_threshold: int = 3, max_indel: int = 9,
                 error_rate: float = 0.44, max_leaves: int = 256):
        self.ix = hix
        self.source = source_seed
        self.target = target_seed
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.threshold = sa_threshold
        self.max_indel = max_indel
        self.error_rate = error_rate
        self.max_leaves = max_leaves

        beginning = source_seed[len(source_seed) - min_overlap:]
        root = _Leaf(source_seed)
        root.f_lo, root.f_hi, root.r_lo, root.r_hi = _find_fwd_rvc(hix, beginning)
        root.last_overlap_len = root.curr_overlap_len = root.query_overlap_len = min_overlap
        root.last_seed_idx = root.init_seed_idx = min_overlap - self.SEED_SIZE
        root.total_seeds = min_overlap - self.SEED_SIZE + 1
        root.num_redeem = 0.0
        self.leaves = [root]

        ending = target_seed[:min_overlap]
        self.max_length = int(1.1 * (dis + 10) + 2 * min_overlap)
        self.min_length = int(0.8 * (dis - 20) + 2 * min_overlap)
        tf = _find_fwd_rvc(hix, ending)
        self.term_f = (tf[0], tf[1])
        self.term_r = (tf[2], tf[3])
        self.cur_len = self.cur_k = min_overlap

        self.query = beginning + between + ending
        q = self.query
        ss = self.SEED_SIZE
        n = len(q) - ss + 1
        enc = ab.encode(q)
        win = np.lib.stride_tricks.sliding_window_view(enc, ss)[:n]
        wf_lo, wf_hi = hix.rbwt.find_interval(win[:, ::-1])
        wr_lo, wr_hi = hix.bwt.find_interval(ab.complement(win)[:, ::-1])
        fwd_iv = [(int(wf_lo[i]), int(wf_hi[i]), i)
                  for i in range(n) if wf_lo[i] <= wf_hi[i]]
        rvc_iv = [(int(wr_lo[i]), int(wr_hi[i]), i)
                  for i in range(n) if wr_lo[i] <= wr_hi[i]]
        self.fwd_tree = ITree(fwd_iv) if fwd_iv else None
        self.rvc_tree = ITree(rvc_iv) if rvc_iv else None

    # ------------------------------------------------------------------
    def _attempt(self):
        new = []
        lv = self.leaves
        if not lv:
            return new
        f_lo, f_hi, r_lo, r_hi, f_ok, r_ok, bcount, keep = _probe_leaves(
            self.ix, lv, self.threshold)
        for i, leaf in enumerate(lv):
            exts = np.flatnonzero(keep[i])
            if len(exts) == 1:
                b = int(exts[0])
                leaf.full += "ACGT"[b]
                leaf.f_lo, leaf.f_hi = int(f_lo[i, b]), int(f_hi[i, b])
                leaf.r_lo, leaf.r_hi = int(r_lo[i, b]), int(r_hi[i, b])
                if leaf.f_lo <= leaf.f_hi:
                    leaf.kmer_count += leaf.f_hi - leaf.f_lo + 1
                if leaf.r_lo <= leaf.r_hi:
                    leaf.kmer_count += leaf.r_hi - leaf.r_lo + 1
                leaf.curr_overlap_len += 1
                leaf.query_overlap_len += 1
                new.append(leaf)
            elif len(exts) > 1:
                for b in exts:
                    c = leaf.clone("ACGT"[int(b)])
                    c.f_lo, c.f_hi = int(f_lo[i, b]), int(f_hi[i, b])
                    c.r_lo, c.r_hi = int(r_lo[i, b]), int(r_hi[i, b])
                    c.kmer_count = leaf.kmer_count
                    if c.f_lo <= c.f_hi:
                        c.kmer_count += c.f_hi - c.f_lo + 1
                    if c.r_lo <= c.r_hi:
                        c.kmer_count += c.r_hi - c.r_lo + 1
                    c.curr_overlap_len += 1
                    c.query_overlap_len += 1
                    new.append(c)
        return new

    def _refine(self, new_k: int) -> None:
        for leaf in self.leaves:
            suffix = leaf.full[len(leaf.full) - new_k:]
            leaf.f_lo, leaf.f_hi, leaf.r_lo, leaf.r_hi = _find_fwd_rvc(
                self.ix, suffix)
        self.cur_k = new_k

    def _extend_leaves(self) -> None:
        new = self._attempt()
        if self.cur_k >= self.max_overlap:
            self._refine(self.min_overlap)
        if not new:
            self._refine(self.min_overlap)
            new = self._attempt()
        if new:
            self.cur_len += 1
            self.cur_k += 1
        self.leaves = new

    def _pruned_by_seed_support(self) -> None:
        """PrunedBySeedSupport (ShortReadOverlapTree.cpp:399-458)."""
        ss = self.SEED_SIZE
        curr_seed_idx = self.cur_len - ss
        indel_off = ss + self.max_indel
        small_idx = 0 if curr_seed_idx <= indel_off else curr_seed_idx - indel_off
        top = len(self.query) - ss
        large_idx = top if curr_seed_idx + indel_off >= top else curr_seed_idx + indel_off
        kept = []
        for leaf in self.leaves:
            gap = self.cur_len - leaf.last_overlap_len
            if gap > ss or gap <= 1:
                found = self._new_seed(leaf, small_idx, large_idx)
                if found:
                    leaf.last_seed_idx_offset = leaf.last_seed_idx - curr_seed_idx
                if not found and curr_seed_idx + leaf.last_seed_idx_offset == leaf.last_seed_idx + 1:
                    leaf.num_errors += 1
                elif not found and curr_seed_idx + leaf.last_seed_idx_offset - leaf.last_seed_idx > ss + 1:
                    leaf.num_redeem += 0.5
            else:
                leaf.num_redeem += 1
            err = self._error_rate(leaf)
            if self.cur_len <= 200 and err > self.error_rate:
                continue
            kept.append(leaf)
        self.leaves = kept

    def _new_seed(self, leaf, small_idx: int, large_idx: int) -> bool:
        """isSupportedByNewSeed (:461-529)."""
        ss = self.SEED_SIZE
        off = ss if leaf.last_overlap_len < self.cur_len - ss else \
            self.cur_len - leaf.last_overlap_len
        start_idx = max(small_idx, leaf.last_seed_idx + off)
        res_f = self.fwd_tree.find_overlapping(leaf.f_lo, leaf.f_hi) \
            if self.fwd_tree is not None and leaf.f_lo <= leaf.f_hi else []
        res_r = self.rvc_tree.find_overlapping(leaf.r_lo, leaf.r_hi) \
            if self.rvc_tree is not None and leaf.r_lo <= leaf.r_hi else []
        found = False
        min_diff = 10000
        curr_seed_idx = self.cur_len - ss
        for i in range(max(len(res_f), len(res_r))):
            if i < len(res_f) and start_idx <= res_f[i][2] <= large_idx:
                v = res_f[i][2]
                if abs(v - curr_seed_idx) < min_diff:
                    leaf.last_seed_idx = v
                    leaf.query_overlap_len = v + ss
                    min_diff = abs(v - curr_seed_idx)
                leaf.last_overlap_len = self.cur_len
                leaf.curr_overlap_len = self.cur_len
                found = True
            elif i < len(res_r) and start_idx <= res_r[i][2] <= large_idx:
                v = res_r[i][2]
                if abs(v - curr_seed_idx) < min_diff:
                    leaf.last_seed_idx = v
                    leaf.query_overlap_len = v + ss
                    min_diff = abs(v - curr_seed_idx)
                leaf.last_overlap_len = self.cur_len
                leaf.curr_overlap_len = self.cur_len
                found = True
        if found:
            leaf.total_seeds += 1
        return found

    def _error_rate(self, leaf) -> float:
        """computeErrorRate (:532-560)."""
        matched = float(leaf.total_seeds) + leaf.num_redeem
        total = float(leaf.curr_overlap_len) - self.SEED_SIZE + 1
        return (total - matched) / total

    def _terminated(self, results) -> None:
        for leaf in self.leaves:
            fv = leaf.f_lo <= leaf.f_hi
            rv = leaf.r_lo <= leaf.r_hi
            if (fv and leaf.f_lo >= self.term_f[0] and leaf.f_hi <= self.term_f[1]) or (
                    rv and leaf.r_lo >= self.term_r[0] and leaf.r_hi <= self.term_r[1]):
                results.append((leaf.full, leaf.kmer_count))

    def extend_overlap(self):
        """extendOverlap -> (code, merged_seq, aln_score)."""
        results = []
        while self.leaves and len(self.leaves) <= self.max_leaves and \
                self.cur_len <= self.max_length:
            self._extend_leaves()
            self._pruned_by_seed_support()
            if len(self.leaves) >= 100:
                # stable sort by totalSeeds desc, keep top 99 (the reference
                # erases from the 100th element on)
                self.leaves.sort(key=lambda l: -l.total_seeds)
                del self.leaves[99:]
            if self.min_length >= 0 and self.cur_len >= self.min_length:
                self._terminated(results)
        if results:
            return self._best_path(results)
        if not self.leaves:
            return -1, "", -100
        if self.cur_len > self.max_length:
            return -2, "", -100
        if len(self.leaves) > self.max_leaves:
            return -3, "", -100
        return -4, "", -100

    def _best_path(self, results):
        """findTheBestPath (:184-229): stdaln vs the full query."""
        best_score = -100
        best = ""
        for thread, _cov in results:
            if len(self.target) > self.min_overlap:
                cand = thread + self.target[self.min_overlap:]
            else:
                cand = thread
            score = aln_score_pacbio(self.query, cand)
            if best_score < score:
                best_score = score
                best = cand
        if best:
            return 1, best, best_score
        return -4, "", -100


# ---------------------------------------------------------------------------
# the corrector
# ---------------------------------------------------------------------------

class HybridCorrector:
    """PacBioHybridCorrectionProcess (reference-fidelity port)."""

    def __init__(self, sr_ix, pb_ix, params: HybridParams):
        self.ix = sr_ix        # short-read index set (HostIndexSet)
        self.pb_ix = pb_ix     # PacBio index set
        self.params = params
        p = params
        # v3 threshold table (:330-345)
        thr = np.full(202, 3.0, np.float64)
        k = np.arange(92)
        thr[:92] += (0.005 * k**2 - 0.96 * k + 45.955) * (p.coverage / 100.0)
        # the reference reads the float table into a size_t
        # dynamicKmerThreshold — comparisons use the TRUNCATED value
        self.kmer_thresholds = thr.astype(np.int64)
        # PB threshold table of seedingByPacBio_v2 (:503-517)
        pthr = np.full(98, 5.0, np.float64)
        k = np.arange(98)
        pthr += (-0.1 * k + 9.7) * (p.pb_coverage / 60.0)
        self.pb_thresholds = pthr.astype(np.int64)  # size_t truncation, as above

    # -- seeding -----------------------------------------------------------
    def _win_intervals(self, read: str, k: int, hix):
        """Bi-intervals of every k-window (vectorised backward search)."""
        enc = ab.encode(read)
        n = len(read) - k + 1
        if n <= 0:
            return None
        win = np.lib.stride_tricks.sliding_window_view(enc, k)[:n]
        f_lo, f_hi = hix.rbwt.find_interval(win[:, ::-1])
        r_lo, r_hi = hix.bwt.find_interval(ab.complement(win)[:, ::-1])
        return enc, f_lo, f_hi, r_lo, r_hi

    def seeding(self, read: str):
        """seedingByDynamicKmer_v3 (:313-440)."""
        p = self.params
        seeds: list[HSeed] = []
        seed_end_pos: list[int] = []
        max_k, min_k = p.kmer_length, p.min_kmer_length
        L = len(read)
        if L <= max_k:
            return seeds
        thr = self.kmer_thresholds
        enc = ab.encode(read)
        w = self._win_intervals(read, min_k, self.ix)
        if w is None:
            return seeds
        _, wf_lo, wf_hi, wr_lo, wr_hi = w
        n_win = len(wf_lo)

        pos = 0
        while pos + min_k < L:
            if pos >= n_win:
                break
            f_lo, f_hi = int(wf_lo[pos]), int(wf_hi[pos])
            r_lo, r_hi = int(wr_lo[pos]), int(wr_hi[pos])
            kmer_freqs = (f_hi - f_lo + 1) + (r_hi - r_lo + 1)
            dyn_k = min_k
            if kmer_freqs < thr[min_k]:
                prev_end = 0 if not seed_end_pos else seed_end_pos[-1] + 1
                dist = pos + 1 - prev_end
                if dist >= p.pb_search_depth:
                    if not self._seeding_by_pacbio(read, seeds, seed_end_pos,
                                                   prev_end):
                        seed_end_pos.append(pos)
                    pos = seed_end_pos[-1]
                pos += 1
                continue

            seed_start = pos
            max_freq = kmer_freqs
            pos = pos + min_k
            while pos < L:
                b = int(enc[pos])
                if f_lo <= f_hi:
                    f_lo, f_hi = (int(x) for x in
                                  self.ix.rbwt.update_interval(f_lo, f_hi, b))
                if r_lo <= r_hi:
                    r_lo, r_hi = (int(x) for x in
                                  self.ix.bwt.update_interval(r_lo, r_hi, 5 - b))
                # NB: replicates the reference's ?: precedence quirk — the
                # rvc count is consulted only when the fwd side is invalid
                if f_lo <= f_hi:
                    kmer_freqs = f_hi - f_lo + 1
                elif r_lo <= r_hi:
                    kmer_freqs = r_hi - r_lo + 1
                else:
                    kmer_freqs = 0
                dyn_k += 1
                if kmer_freqs >= thr[dyn_k]:
                    max_freq = kmer_freqs
                    pos += 1
                else:
                    dyn_k -= 1
                    break

            seed_end = pos - 1
            if max_freq >= p.coverage * 4:
                seed_start, seed_end = self._trim_repeat_seed(
                    read, p.coverage, seed_start, seed_end)
            is_super = max_freq > p.coverage * 15
            new_seed = HSeed(seed_start, read[seed_start : seed_end + 1],
                             is_super, dyn_k, p.pb_coverage // 2)
            new_seed.estimate_best_kmer_size(self.pb_ix)
            if not is_low_complexity(new_seed.seed_str, 0.9):
                seeds.append(new_seed)
            seed_end_pos.append(seed_end)
            pos = seed_end
            pos += 1
        return seeds

    def _seeding_by_pacbio(self, read: str, seeds, seed_end_pos,
                           prev_end: int) -> bool:
        """seedingByPacBio_v2 (:497-580)."""
        p = self.params
        thr = self.pb_thresholds
        L = len(read)
        enc = ab.encode(read)
        pos = prev_end
        while pos + p.pb_kmer_length < L and pos - prev_end <= p.pb_search_depth:
            dyn_k = p.pb_kmer_length
            word = ab.encode(read[pos : pos + dyn_k])
            f_lo, f_hi = (int(x) for x in
                          self.pb_ix.rbwt.find_interval(word[::-1].copy()))
            r_lo, r_hi = (int(x) for x in
                          self.pb_ix.bwt.find_interval(ab.reverse_complement(word)))
            kmer_freqs = (f_hi - f_lo + 1) + (r_hi - r_lo + 1)
            if kmer_freqs < thr[dyn_k]:
                pos += 1
                continue
            seed_start = pos
            max_freq = kmer_freqs
            pos += 1
            while pos + dyn_k < L:
                b = int(enc[pos])
                if f_lo <= f_hi:
                    f_lo, f_hi = (int(x) for x in
                                  self.pb_ix.rbwt.update_interval(f_lo, f_hi, b))
                if r_lo <= r_hi:
                    r_lo, r_hi = (int(x) for x in
                                  self.pb_ix.bwt.update_interval(r_lo, r_hi, 5 - b))
                if f_lo <= f_hi:
                    kmer_freqs = f_hi - f_lo + 1
                elif r_lo <= r_hi:
                    kmer_freqs = r_hi - r_lo + 1
                else:
                    kmer_freqs = 0
                dyn_k += 1
                if dyn_k >= len(thr):
                    break
                if kmer_freqs >= thr[dyn_k]:
                    max_freq = kmer_freqs
                    pos += 1
                else:
                    dyn_k -= 1
                    break
            if max_freq >= p.pb_coverage * 2:
                continue
            if max_freq >= p.pb_coverage and dyn_k - p.pb_kmer_length <= 4:
                continue
            seed_end = pos - 1
            is_super = max_freq >= p.pb_coverage
            new_seed = HSeed(seed_start, read[seed_start : seed_end + 1],
                             is_super, dyn_k, p.pb_coverage // 2)
            new_seed.estimate_best_kmer_size(self.pb_ix)
            if not is_low_complexity(new_seed.seed_str, 0.8):
                new_seed.is_pb_seed = True
                seeds.append(new_seed)
                seed_end_pos.append(seed_end)
                return True
        return False

    def _both_strand_count(self, word: str) -> int:
        """countSequenceOccurrences on the short-read index."""
        codes = ab.encode(word)
        lo1, hi1 = self.ix.rbwt.find_interval(codes[::-1].copy())
        lo2, hi2 = self.ix.bwt.find_interval(ab.reverse_complement(codes))
        return max(int(hi1) - int(lo1) + 1, 0) + max(int(hi2) - int(lo2) + 1, 0)

    def _trim_repeat_seed(self, read: str, coverage: int, start: int, end: int):
        """trimRepeatSeed (:1133-1215)."""
        p = self.params
        UNSET = -1
        new_start = UNSET
        new_end = UNSET
        k = p.kmer_length
        min_repeat = coverage
        min_diff = 0.5
        init_freq = self._both_strand_count(read[start : start + k])
        prev = init_freq
        start_freq = 0
        if init_freq > min_repeat:
            new_start = start
            start_freq = init_freq
        i = start + 1
        while i + k - 1 <= end:
            curr = self._both_strand_count(read[i : i + k])
            large_up = curr > 0 and (curr - prev) / curr > min_diff
            is_repeat_kmer = new_start == UNSET and curr >= min_repeat
            if large_up or is_repeat_kmer:
                better = start_freq != 0 and curr > start_freq
                if new_start == UNSET or better:
                    new_start = i
                    start_freq = curr
            large_down = prev > 0 and (prev - curr) / prev > min_diff
            if large_down:
                new_end = i + k - 2
                break
            prev = curr
            i += 1
        if new_start == UNSET:
            new_start = start
        if new_end == UNSET:
            new_end = end
        return new_start, new_end

    # -- extension ----------------------------------------------------------
    def extend_between_seeds(self, source: HSeed, target: HSeed,
                             str_between: str, dis: int):
        """extendBetweenSeeds (:872-1065) -> (code, merged_seq)."""
        p = self.params
        code = -2
        prev_code = 0
        min_overlap = min(source.seed_len, target.seed_len, p.max_overlap)
        init_min_overlap = min_overlap
        merged = ""
        best_score = -100
        is_sequencing_gap = False
        is_seed_from_pb = source.is_pb_seed or target.is_pb_seed or source.is_next_repeat

        while code in (-1, -2) and min_overlap >= p.min_kmer_length and \
                not is_seed_from_pb:
            t1 = PBHybridCTree(self.ix, source.seed_str, target.seed_str,
                               str_between, dis, min_overlap, p.max_overlap,
                               p.max_leaves, p.fmw_kmer_threshold, p.coverage)
            code, merged, best_score = t1.merge_two_seeds()
            if code > 0:
                t2 = PBHybridCTree(
                    self.ix, ab.revcomp_str(target.seed_str),
                    ab.revcomp_str(source.seed_str),
                    ab.revcomp_str(str_between), dis, min_overlap,
                    p.max_overlap, p.max_leaves, p.fmw_kmer_threshold,
                    p.coverage)
                code2, merged2, score2 = t2.merge_two_seeds()
                code = code2
                if len(merged) == len(merged2):
                    if best_score < score2:
                        merged = ab.revcomp_str(merged2)
                    return 1, merged
                if code2 > 0:
                    code = -4
            if (code == -2 and min_overlap >= p.kmer_length) or \
                    (code == -1 and min_overlap == init_min_overlap):
                is_sequencing_gap = True
            if code == -3 and prev_code == -1:
                code = prev_code
                break
            prev_code = code
            min_overlap -= 1
            if source.is_repeat and min_overlap < p.kmer_length - 1:
                break

        # ShortReadOverlapTree retry ladder (:969-1036)
        min_overlap = init_min_overlap
        while code < 0 and min_overlap >= p.min_kmer_length and not is_seed_from_pb:
            t1 = ShortReadOverlapTree(
                self.ix, source.seed_str, str_between[10 : 10 + dis],
                target.seed_str, dis, min_overlap, p.max_overlap)
            code, merged, best_score = t1.extend_overlap()
            if code > 0:
                t2 = ShortReadOverlapTree(
                    self.ix, ab.revcomp_str(target.seed_str),
                    ab.revcomp_str(str_between[10 : 10 + dis]),
                    ab.revcomp_str(source.seed_str), dis, min_overlap,
                    p.max_overlap)
                code2, merged2, score2 = t2.extend_overlap()
                if code2 > 0:
                    if best_score < score2:
                        merged = ab.revcomp_str(merged2)
                    return 1, merged
                code = -4 if code > 0 else code
            if (code == -2 and min_overlap >= p.kmer_length) or \
                    (code == -1 and min_overlap == init_min_overlap):
                is_sequencing_gap = True
            if code == -3 and prev_code == -1:
                code = prev_code
                break
            prev_code = code
            min_overlap -= 1
            if source.is_repeat and min_overlap < p.kmer_length - 1:
                break

        # MSA fallback on the PB index for sequencing gaps (:1040-1062)
        if code in (-1, -2) and not source.is_repeat and not target.is_repeat \
                and (is_sequencing_gap or is_seed_from_pb):
            from . import msa as msamod

            query = (source.seed_str[source.seed_len - source.end_best_kmer_size:]
                     + str_between[10 : 10 + dis] + target.seed_str)
            maquery = msamod.build_multiple_alignment(
                query, source.end_best_kmer_size, target.end_best_kmer_size,
                len(query) // 10, 0.73, p.pb_coverage, self.pb_ix)
            if maquery.num_rows() <= 3:
                return code, ""
            consensus = maquery.calculate_base_consensus(100000, -1)
            merged = source.seed_str + consensus[p.pb_kmer_length:]
            return 1, merged

        if code > 0:
            return 1, merged
        return code, ""

    # -- main per-read process ----------------------------------------------
    def correct(self, read_id: str, read: str):
        """PBHybridCorrection (:33-200)."""
        seeds = self.seeding(read)
        result = {
            "read_id": read_id, "merge": False, "corrected_strs": [],
            "total_seed_num": len(seeds), "corrected_num": 0, "walk_num": 0,
            "total_reads_len": len(read), "corrected_len": 0, "seed_dis": 0,
        }
        if len(seeds) < 2:
            return result
        result["corrected_len"] += seeds[0].seed_len
        pieces = [HSeed(seeds[0].seed_start_pos, seeds[0].seed_str,
                        seeds[0].is_repeat, seeds[0].min_kmer_size,
                        self.params.pb_coverage // 2)]
        pieces[0].start_best_kmer_size = seeds[0].start_best_kmer_size
        pieces[0].end_best_kmer_size = seeds[0].end_best_kmer_size
        pieces[0].is_pb_seed = seeds[0].is_pb_seed
        pieces[0].is_next_repeat = seeds[0].is_next_repeat

        for t in range(1, len(seeds)):
            pre = seeds[t - 1]
            source = pieces[-1]
            target = seeds[t]
            dis = target.seed_start_pos - pre.seed_end_pos - 1
            lo = pre.seed_end_pos + 1 - 10
            str_between = read[max(lo, 0) : max(lo, 0) + dis + 20]
            code, merged = self.extend_between_seeds(source, target,
                                                     str_between, dis)
            if code == 1:
                gain_pos = source.seed_len
                if len(merged) > gain_pos:
                    gain = merged[gain_pos:]
                    source.seed_str += gain
                    source.seed_len += len(gain)
                    source.is_repeat = target.is_repeat
                    source.is_pb_seed = target.is_pb_seed
                    source.is_next_repeat = target.is_next_repeat
                    source.start_best_kmer_size = target.start_best_kmer_size
                    source.end_best_kmer_size = target.end_best_kmer_size
                    source.seed_end_pos = target.seed_end_pos
                    source.seed_start_pos = target.seed_start_pos
                    result["corrected_len"] += len(gain)
            else:
                pieces.append(target)
                result["corrected_len"] += target.seed_len
            result["walk_num"] += 1
            result["seed_dis"] += dis
            if code == 1:
                result["corrected_num"] += 1

        result["merge"] = True
        result["corrected_strs"] = [p.seed_str for p in pieces]
        return result
