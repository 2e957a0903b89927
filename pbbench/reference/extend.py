"""Seed-to-seed FM-extension walk (host engine).

Faithful re-implementation of PacBio/LongReadCorrectByOverlap.{h,cpp}: a
bounded-beam BFS from a source seed toward a target seed through the implicit
FM-index graph, with adaptive k-mer size, threshold relaxation, seed-support
pruning against the raw-read query, and terminal-interval containment checks.

This host engine is the golden semantic model; the batched device frontier
(ops/extend kernels) must reproduce it.  All reference quirks are preserved —
size_t wraparound in the redeem bookkeeping, float truncations of min/max
lengths, result ordering of the interval trees, the exact relaxation ladder.

Return codes of extend() mirror extendOverlap (LongReadCorrectByOverlap.cpp:
155-211): >0 success, -1 high error, -2 exceeded depth, -3 exceeded leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import alphabet as ab
from .itree import make_tree

U64 = 1 << 64
RANK_CHARS = "$ACGT"


def _revcomp(s: str) -> str:
    return ab.revcomp_str(s)


def _interval_size(lo: int, hi: int) -> int:
    return hi - lo + 1 if lo <= hi else 0


@dataclass
class FMExtendParams:
    """FMextendParameters (LongReadCorrectByOverlap.h:28-47)."""

    idmer_length: int = 9
    max_leaves: int = 32
    min_kmer_length: int = 13
    pb_coverage: int = 90
    error_rate: float = 0.15  # PacBio raw error rate


@dataclass
class Leaf:
    """SAIOverlapNode3 + leafInfo merged (SAINode.h:301-354,
    LongReadCorrectByOverlap.h:154-217)."""

    full: str                     # root-to-leaf string (label concatenation)
    fwd_lo: int; fwd_hi: int      # interval of reverse(full-suffix) in RBWT
    rvc_lo: int; rvc_hi: int      # interval of revcomp(full-suffix) in BWT
    total_kmer_count: int = 0
    last_kmer_count: int = 0
    last_seed_idx: int = 0
    last_overlap_len: int = 0
    total_seeds: int = 0
    curr_overlap_len: int = 0
    num_of_errors: int = 0
    last_seed_idx_offset: int = 0
    init_seed_idx: int = 0
    query_overlap_len: int = 0
    num_redeem_seed: float = 0.0
    result_index: tuple[int, int] = (-1, -1)
    local_err: list[float] = field(default_factory=list)
    global_err: list[float] = field(default_factory=list)
    # leafInfo
    last_leaf_id: int = 1
    kmer_frequency: int = 0
    tail_letter: str = ""
    tail_letter_count: int = 0

    def fwd_valid(self) -> bool:
        return self.fwd_lo <= self.fwd_hi

    def rvc_valid(self) -> bool:
        return self.rvc_lo <= self.rvc_hi

    def clone_for_branch(self, ext_char: str) -> "Leaf":
        """createChild (SAINode.cpp:165-188): copies walk bookkeeping, resets
        kmer counts (re-added by the caller), appends the label."""
        return Leaf(
            full=self.full + ext_char,
            fwd_lo=self.fwd_lo, fwd_hi=self.fwd_hi,
            rvc_lo=self.rvc_lo, rvc_hi=self.rvc_hi,
            total_kmer_count=0, last_kmer_count=0,
            last_seed_idx=self.last_seed_idx,
            last_overlap_len=self.last_overlap_len,
            total_seeds=self.total_seeds,
            curr_overlap_len=self.curr_overlap_len,
            num_of_errors=self.num_of_errors,
            last_seed_idx_offset=self.last_seed_idx_offset,
            init_seed_idx=self.init_seed_idx,
            query_overlap_len=self.query_overlap_len,
            num_redeem_seed=self.num_redeem_seed,
            result_index=self.result_index,
            local_err=list(self.local_err),
            global_err=list(self.global_err),
        )


@dataclass
class WalkResult:
    merged_seq: str = ""
    # diagnostic fields from SAIntervalNodeResult
    sai_coverage: int = 0
    error_rate: float = 0.0
    sa_interval_size: int = 0


class HostExtendEngine:
    """LongReadSelfCorrectByOverlap (one seed-gap walk)."""

    def __init__(
        self,
        ix,                      # HostIndexSet
        source_seed: str,
        str_between: str,
        target_seed: str,
        dis_between: int,
        init_kmer_size: int,
        max_overlap: int,
        params: FMExtendParams,
        min_sa_threshold: int = 3,
        error_rate: float = 0.25,
        local_similarly_kmer_size: int = 100,
    ):
        self.ix = ix
        self.src = source_seed
        self.trg = target_seed
        self.dis = dis_between
        self.init_k = init_kmer_size
        self.min_overlap = params.min_kmer_length
        self.max_overlap = max_overlap
        self.pb_coverage = params.pb_coverage
        self.min_sa_threshold = min_sa_threshold
        self.error_rate_bound = error_rate
        self.max_leaves = params.max_leaves
        self.seed_size = params.idmer_length
        self.local_k = local_similarly_kmer_size
        self.pacbio_error_rate = params.error_rate

        beginning = self.src[len(self.src) - init_kmer_size:]
        self.max_indel = int(dis_between * 0.2) if dis_between > 100 else 20

        f_lo, f_hi = self._find(self.ix.rbwt, beginning[::-1])
        r_lo, r_hi = self._find(self.ix.bwt, _revcomp(beginning))
        root = Leaf(full=beginning, fwd_lo=f_lo, fwd_hi=f_hi, rvc_lo=r_lo, rvc_hi=r_hi)
        root.last_overlap_len = root.curr_overlap_len = root.query_overlap_len = init_kmer_size
        root.last_seed_idx = root.init_seed_idx = init_kmer_size - self.seed_size
        root.total_seeds = init_kmer_size - self.seed_size + 1
        root.local_err = [0.0]
        root.global_err = [0.0]
        # leafInfo(root): trailing run of the label
        root.tail_letter = beginning[-1]
        n = 0
        for chx in reversed(beginning):
            if chx == beginning[-1]:
                n += 1
            else:
                break
        root.tail_letter_count = n
        root.kmer_frequency = _interval_size(f_lo, f_hi) + _interval_size(r_lo, r_hi)
        self.leaves: list[Leaf] = [root]

        self.current_length = init_kmer_size
        self.current_kmer_size = init_kmer_size

        # expected both-strand freq per k (LongReadCorrectByOverlap.cpp:68-70)
        self.freqs_of_kmer_size = np.zeros(101)
        for i in range(self.min_overlap, 101):
            self.freqs_of_kmer_size[i] = ((1 - self.pacbio_error_rate) ** i) * self.pb_coverage

        # length window, with the reference's double->size_t conversions
        # (LongReadCorrectByOverlap.cpp:78-79)
        v = 1.2 * (dis_between + 10) + 2 * init_kmer_size
        self.max_length = int(v) if v >= 0 else U64 + int(v)
        v = 0.8 * (dis_between - 20) + 2 * init_kmer_size
        self.min_length = int(v) if v >= 0 else U64 + int(v)

        # terminal intervals per target-suffix offset (:82-88), batched
        trg_enc = ab.encode(self.trg)
        win = np.lib.stride_tricks.sliding_window_view(trg_enc, self.min_overlap)
        tf_lo, tf_hi = self.ix.rbwt.find_interval(win[:, ::-1])
        tr_lo, tr_hi = self.ix.bwt.find_interval(ab.complement(win)[:, ::-1])
        self.fwd_terminated = list(zip(tf_lo.tolist(), tf_hi.tolist()))
        self.rvc_terminated = list(zip(tr_lo.tolist(), tr_hi.tolist()))

        # query seed-interval trees for idmer and 5-mer matching (:90-95)
        self.query = beginning + str_between + self.trg
        self.fwd_tree, self.rvc_tree = self._build_overlap_trees(self.seed_size)
        self.fwd_tree2, self.rvc_tree2 = self._build_overlap_trees(5)

        self.total_count = 0
        self.min_total_count = 10000000

    # ------------------------------------------------------------------
    def _find(self, fm, word: str):
        lo, hi = fm.find_interval(ab.encode(word))
        return int(lo), int(hi)

    def _build_overlap_trees(self, overlap_size: int):
        """Intervals of every query k-mer, batched over all positions."""
        q = ab.encode(self.query)
        n = len(q) - overlap_size + 1
        if n <= 0:
            return make_tree([]), make_tree([])
        win = np.lib.stride_tricks.sliding_window_view(q, overlap_size)
        f_lo, f_hi = self.ix.rbwt.find_interval(win[:, ::-1])
        r_lo, r_hi = self.ix.bwt.find_interval(ab.complement(win)[:, ::-1])
        fwd_ivals = [
            (int(f_lo[i]), int(f_hi[i]), i) for i in range(n) if f_lo[i] <= f_hi[i]
        ]
        rvc_ivals = [
            (int(r_lo[i]), int(r_hi[i]), i) for i in range(n) if r_lo[i] <= r_hi[i]
        ]
        return make_tree(fwd_ivals), make_tree(rvc_ivals)

    # ------------------------------------------------------------------
    def extend(self) -> tuple[int, WalkResult]:
        """extendOverlap (:155-211)."""
        results: list[WalkResult] = []
        while self.leaves and len(self.leaves) <= self.max_leaves and self.current_length <= self.max_length:
            new_leaves: list[Leaf] = []
            self._extend_leaves(new_leaves)
            self._pruned_by_seed_support(new_leaves)
            self.leaves = new_leaves
            if self.current_length >= self.min_length:
                self._is_terminated(results)

        if results:
            return self._find_best_path(results)
        if not self.leaves:
            return -1, WalkResult()
        elif self.current_length > self.max_length:
            return -2, WalkResult()
        elif len(self.leaves) > self.max_leaves:
            return -3, WalkResult()
        return -4, WalkResult()

    def _find_best_path(self, results: list[WalkResult]) -> tuple[int, WalkResult]:
        """findTheBestPath (:214-236): first strict minimum error rate."""
        min_err = 1.0
        best = WalkResult()
        for r in results:
            if r.error_rate < min_err:
                min_err = r.error_rate
                best = r
                self.min_total_count = r.sa_interval_size
        if best.merged_seq:
            return 1, best
        return -4, best

    # ------------------------------------------------------------------
    def _extend_leaves(self, new_leaves: list[Leaf]) -> None:
        """extendLeaves (:239-278)."""
        if self.current_kmer_size > self.max_overlap:
            self._refine_sa_interval(self.leaves, self.max_overlap)

        self._attempt_to_extend(new_leaves)

        if not new_leaves:  # level 1: reduce kmer size
            lower = max(self.current_kmer_size - 2, self.min_overlap)
            reduce_size = self._select_freqs_of_range(lower, self.current_kmer_size, self.leaves)
            self._refine_sa_interval(self.leaves, reduce_size)
            self._attempt_to_extend(new_leaves)

            if not new_leaves:  # level 2: reduce threshold
                self.min_sa_threshold -= 1
                self._attempt_to_extend(new_leaves)
                self.min_sa_threshold += 1

        if new_leaves:
            self.current_length += 1
            self.current_kmer_size += 1
            if self._is_insufficient_freqs(new_leaves):
                lower = max(self.current_kmer_size - 2, self.min_overlap)
                reduce_size = self._select_freqs_of_range(lower, self.current_kmer_size, new_leaves)
                self._refine_sa_interval(new_leaves, reduce_size)

    def _select_freqs_of_range(self, lower: int, upper: int, leaves: list[Leaf]) -> int:
        """SelectFreqsOfrange (:281-331): pick the smallest k in [lower,upper]
        whose max leaf-suffix frequency stays near the expected freq."""
        max_kmers = []   # (string, fwd interval in BWT, rvc interval in RBWT)
        tempmax = 0
        for leaf in leaves:
            max_kmer = leaf.full[len(leaf.full) - upper:]
            start = max_kmer[upper - lower:]
            f_lo, f_hi = self._find(self.ix.bwt, start)
            # reverseComplement(reverse(s)) == complement(s)
            comp = "".join("TGCA"["ACGT".index(c)] for c in start)
            r_lo, r_hi = self._find(self.ix.rbwt, comp)
            freq = _interval_size(f_lo, f_hi) + _interval_size(r_lo, r_hi)
            max_kmers.append([max_kmer, f_lo, f_hi, r_lo, r_hi])
            if freq > tempmax:
                tempmax = freq
        if tempmax - int(self.freqs_of_kmer_size[lower]) < 5:
            return lower
        for i in range(1, upper - lower + 1):
            tempmax = 0
            for mk in max_kmers:
                s = mk[0][upper - lower - i:]
                b = s[0]
                rcb = "TGCA"["ACGT".index(b)]
                mk[1], mk[2] = (int(x) for x in self.ix.bwt.update_interval(mk[1], mk[2], ab.encode(b)[0]))
                mk[3], mk[4] = (int(x) for x in self.ix.rbwt.update_interval(mk[3], mk[4], ab.encode(rcb)[0]))
                freq = _interval_size(mk[1], mk[2]) + _interval_size(mk[3], mk[4])
                if freq > tempmax:
                    tempmax = freq
            if tempmax - int(self.freqs_of_kmer_size[lower + i]) < 5:
                return lower + i
        return upper

    def _is_insufficient_freqs(self, new_leaves: list[Leaf]) -> bool:
        """isInsufficientFreqs (:334-352)."""
        high = 0
        for leaf in new_leaves:
            threshold = (self.pb_coverage // 60) * 3 if self.pb_coverage > 60 else 3
            if leaf.kmer_frequency > threshold:
                high += 1
        if high == 0:
            return True
        if high <= 2 and len(new_leaves) >= 5:
            return True
        if high <= 1 and len(new_leaves) >= 3:
            return True
        return False

    def _refine_sa_interval(self, leaves: list[Leaf], new_kmer_size: int) -> None:
        """refineSAInterval (:355-369), batched over leaves."""
        if leaves:
            words = np.stack(
                [ab.encode(leaf.full[len(leaf.full) - new_kmer_size:]) for leaf in leaves]
            )
            f_lo, f_hi = self.ix.rbwt.find_interval(words[:, ::-1])
            r_lo, r_hi = self.ix.bwt.find_interval(ab.complement(words)[:, ::-1])
            for k, leaf in enumerate(leaves):
                leaf.fwd_lo, leaf.fwd_hi = int(f_lo[k]), int(f_hi[k])
                leaf.rvc_lo, leaf.rvc_hi = int(r_lo[k]), int(r_hi[k])
        self.current_kmer_size = new_kmer_size

    # ------------------------------------------------------------------
    def _attempt_to_extend(self, new_leaves: list[Leaf]) -> None:
        """attempToExtend (:373-465)."""
        minimum_error_rate = 1.0
        for leaf in self.leaves:
            if leaf.local_err[-1] < minimum_error_rate:
                minimum_error_rate = leaf.local_err[-1]

        kept = []
        for leaf in self.leaves:
            diff = leaf.local_err[-1] - minimum_error_rate
            if (diff > 0.05 and self.current_length > self.local_k / 2) or (
                diff > 0.1 and self.current_length > 15
            ):
                continue
            kept.append(leaf)
        self.leaves = kept

        probes = self._batch_probe_extensions(self.leaves)

        self.min_total_count = 10000000
        curr_leaves_num = 1
        for li, leaf in enumerate(self.leaves):
            count = 0
            while count < 2:
                if count == 1 and not (
                    leaf.local_err[-1] == minimum_error_rate and len(self.leaves) > 1
                ):
                    break
                extensions = self._get_fm_index_extensions(leaf, probes[li])
                if extensions:
                    self._update_leaves(new_leaves, extensions, leaf, curr_leaves_num)
                    break
                self.min_sa_threshold -= 1
                count += 1
            self.min_sa_threshold += count
            if self.min_total_count >= self.total_count:
                self.min_total_count = self.total_count
            curr_leaves_num += 1

    def _batch_probe_extensions(self, leaves: list[Leaf]):
        """The 4-way ACGT interval probes for every leaf in one vectorised
        pass (the per-leaf semantics of getFMIndexExtensions :686-718)."""
        if not leaves:
            return []
        n = len(leaves)
        f_lo = np.array([l.fwd_lo for l in leaves])[:, None].repeat(4, 1)
        f_hi = np.array([l.fwd_hi for l in leaves])[:, None].repeat(4, 1)
        r_lo = np.array([l.rvc_lo for l in leaves])[:, None].repeat(4, 1)
        r_hi = np.array([l.rvc_hi for l in leaves])[:, None].repeat(4, 1)
        syms = np.arange(1, 5)[None, :].repeat(n, 0)
        f_valid = f_lo <= f_hi
        nf_lo, nf_hi = self.ix.rbwt.update_interval(f_lo, f_hi, syms)
        f_lo = np.where(f_valid, nf_lo, f_lo)
        f_hi = np.where(f_valid, nf_hi, f_hi)
        r_valid = r_lo <= r_hi
        nr_lo, nr_hi = self.ix.bwt.update_interval(r_lo, r_hi, 5 - syms)
        r_lo = np.where(r_valid, nr_lo, r_lo)
        r_hi = np.where(r_valid, nr_hi, r_hi)
        freq = np.maximum(f_hi - f_lo + 1, 0) + np.maximum(r_hi - r_lo + 1, 0)
        return [
            [
                (RANK_CHARS[i + 1], int(f_lo[k, i]), int(f_hi[k, i]),
                 int(r_lo[k, i]), int(r_hi[k, i]), int(freq[k, i]))
                for i in range(4)
            ]
            for k in range(n)
        ]

    def _update_leaves(self, new_leaves, extensions, leaf: Leaf, curr_leaves_num: int) -> None:
        """updateLeaves (:468-488)."""
        def finish(node: Leaf, ext) -> Leaf:
            ch, f_lo, f_hi, r_lo, r_hi, freq = ext
            node.fwd_lo, node.fwd_hi = f_lo, f_hi
            node.rvc_lo, node.rvc_hi = r_lo, r_hi
            node.total_kmer_count += freq
            node.last_kmer_count = freq
            node.curr_overlap_len += 1
            node.query_overlap_len += 1
            node.kmer_frequency = freq
            node.last_leaf_id = curr_leaves_num
            if leaf.tail_letter == ch:
                node.tail_letter = leaf.tail_letter
                node.tail_letter_count = leaf.tail_letter_count + 1
            else:
                node.tail_letter = ch
                node.tail_letter_count = 1
            return node

        if len(extensions) == 1:
            ch = extensions[0][0]
            node = leaf
            node.full += ch
            new_leaves.append(finish(node, extensions[0]))
        else:
            parent_count = leaf.total_kmer_count
            for ext in extensions:
                child = leaf.clone_for_branch(ext[0])
                child.total_kmer_count = parent_count
                child.last_kmer_count = parent_count
                new_leaves.append(finish(child, ext))

    # ------------------------------------------------------------------
    def _get_fm_index_extensions(self, leaf: Leaf, probes):
        """getFMIndexExtensions (:667-784) cutoff logic over precomputed
        probes; returns list of (char, fwd_lo, fwd_hi, rvc_lo, rvc_hi, freq)."""
        cutoff = self.min_sa_threshold
        self.total_count = 0
        max_freq_of_leaf = 0
        for (_b, _fl, _fh, _rl, _rh, freq) in probes:
            self.total_count += freq
            if freq > max_freq_of_leaf:
                max_freq_of_leaf = freq

        out = []
        for (b, f_lo, f_hi, r_lo, r_hi, freq) in probes:
            if freq == 0 and max_freq_of_leaf == 0:
                kmer_ratio = float("nan")
            elif max_freq_of_leaf == 0:
                kmer_ratio = math.inf
            else:
                kmer_ratio = freq / max_freq_of_leaf
            is_homopolymer = leaf.tail_letter_count >= 3
            is_matched_by_5mer = self._is_matched_by_kmer(f_lo, f_hi, r_lo, r_hi)
            is_freq_pass = freq >= cutoff
            is_low_coverage = self.total_count >= cutoff + 2
            is_repeat = max_freq_of_leaf > 100
            is_highly_repeat = max_freq_of_leaf > 150
            is_lowly_repeat = max_freq_of_leaf > 50
            if is_matched_by_5mer and is_highly_repeat:
                ratio_cutoff = 0.125
            elif is_matched_by_5mer and is_lowly_repeat:
                ratio_cutoff = 0.2
            elif is_freq_pass:
                ratio_cutoff = 0.25
            elif is_low_coverage:
                ratio_cutoff = 0.6
            else:
                ratio_cutoff = 2.0  # not passable
            if is_homopolymer and is_repeat:
                ratio_cutoff = max(ratio_cutoff, 0.3)
            elif is_homopolymer:
                ratio_cutoff = max(ratio_cutoff, 0.6)
            if kmer_ratio >= ratio_cutoff:
                out.append((b, f_lo, f_hi, r_lo, r_hi, freq))
        return out

    def _is_matched_by_kmer(self, f_lo, f_hi, r_lo, r_hi) -> bool:
        """ismatchedbykmer (:787-821): 5-mer query-position support."""
        results_fwd = self.fwd_tree2.find_overlapping(f_lo, f_hi) if f_lo <= f_hi else []
        results_rvc = self.rvc_tree2.find_overlapping(r_lo, r_hi) if r_lo <= r_hi else []
        start_idx = max(self.current_length - self.max_indel, 0)
        large_idx = self.current_length + self.max_indel
        for i in range(max(len(results_fwd), len(results_rvc))):
            if (
                f_lo <= f_hi
                and i < len(results_fwd)
                and start_idx <= results_fwd[i][2] <= large_idx
            ):
                return True
            elif (
                r_lo <= r_hi
                and i < len(results_rvc)
                and start_idx <= results_rvc[i][2] <= large_idx
            ):
                return True
        return False

    # ------------------------------------------------------------------
    def _pruned_by_seed_support(self, new_leaves: list[Leaf]) -> None:
        """PrunedBySeedSupport (:491-563)."""
        curr_seed_idx = self.current_length - self.seed_size
        indel_offset = self.seed_size + self.max_indel
        small_idx = 0 if curr_seed_idx <= indel_offset else curr_seed_idx - indel_offset
        qmax = len(self.query) - self.seed_size
        large_idx = qmax if curr_seed_idx + indel_offset >= qmax else curr_seed_idx + indel_offset

        kept = []
        for leaf in new_leaves:
            if (
                self.current_length - leaf.last_overlap_len > self.seed_size
                or self.current_length - leaf.last_overlap_len <= 1
            ):
                pre_seed_idx = leaf.last_seed_idx
                found = self._is_supported_by_new_seed(leaf, small_idx, large_idx)
                if found:
                    # size_t wraparound semantics preserved
                    v = (curr_seed_idx + leaf.last_seed_idx_offset - pre_seed_idx) % U64
                    if v > self.seed_size:
                        leaf.num_redeem_seed += (self.seed_size - 1) * self.pacbio_error_rate
                    leaf.last_seed_idx_offset = leaf.last_seed_idx - curr_seed_idx
                else:
                    v = (curr_seed_idx + leaf.last_seed_idx_offset - leaf.last_seed_idx) % U64
                    if v % self.seed_size == 1:
                        leaf.num_of_errors += 1
                    elif v > self.seed_size - 1:
                        leaf.num_redeem_seed += 1 - self.pacbio_error_rate
            else:
                leaf.num_redeem_seed += 1 - self.pacbio_error_rate

            err = self._compute_error_rate(leaf)
            if err > self.error_rate_bound:
                continue
            kept.append(leaf)
        new_leaves[:] = kept

    def _is_supported_by_new_seed(self, leaf: Leaf, small_idx: int, large_idx: int) -> bool:
        """isSupportedByNewSeed (:566-635)."""
        if leaf.last_overlap_len < self.current_length - self.seed_size:
            seed_idx_offset = self.seed_size
        else:
            seed_idx_offset = self.current_length - leaf.last_overlap_len
        start_idx = max(small_idx, leaf.last_seed_idx + seed_idx_offset)

        results_fwd = (
            self.fwd_tree.find_overlapping(leaf.fwd_lo, leaf.fwd_hi) if leaf.fwd_valid() else []
        )
        results_rvc = (
            self.rvc_tree.find_overlapping(leaf.rvc_lo, leaf.rvc_hi) if leaf.rvc_valid() else []
        )
        min_idx_diff = 10000
        curr_seed_idx = self.current_length - self.seed_size
        found = False
        for i in range(max(len(results_fwd), len(results_rvc))):
            if (
                leaf.fwd_valid()
                and i < len(results_fwd)
                and start_idx <= results_fwd[i][2] <= large_idx
            ):
                value = results_fwd[i][2]
                if abs(value - curr_seed_idx) < min_idx_diff:
                    leaf.last_seed_idx = value
                    leaf.query_overlap_len = value + self.seed_size
                    min_idx_diff = abs(value - curr_seed_idx)
                leaf.last_overlap_len = self.current_length
                leaf.curr_overlap_len = self.current_length
                found = True
            elif (
                leaf.rvc_valid()
                and i < len(results_rvc)
                and start_idx <= results_rvc[i][2] <= large_idx
            ):
                value = results_rvc[i][2]
                if abs(curr_seed_idx - value) < min_idx_diff:
                    leaf.last_seed_idx = value
                    leaf.query_overlap_len = value + self.seed_size
                    min_idx_diff = abs(curr_seed_idx - value)
                leaf.last_overlap_len = self.current_length
                leaf.curr_overlap_len = self.current_length
                found = True
        if found:
            leaf.total_seeds += 1
        return found

    def _compute_error_rate(self, leaf: Leaf) -> float:
        """computeErrorRate (:638-664)."""
        matched = float(leaf.total_seeds) + self.seed_size - 1
        matched += leaf.num_redeem_seed
        total = float(leaf.curr_overlap_len)
        err = (total - matched) / total
        leaf.global_err.append(err)
        if len(leaf.global_err) >= self.local_k:
            n = len(leaf.global_err)
            err = (
                err * total - leaf.global_err[n - self.local_k] * (total - self.local_k)
            ) / self.local_k
        leaf.local_err.append(err)
        return err

    # ------------------------------------------------------------------
    def _is_terminated(self, results: list[WalkResult]) -> bool:
        """isTerminated (:824-877)."""
        found = False
        for leaf in self.leaves:
            i = max(leaf.result_index[1], 0)
            while i <= len(self.trg) - self.min_overlap:
                fwd_term = self.fwd_terminated[i]
                rvc_term = self.rvc_terminated[i]
                is_fwd = (
                    leaf.fwd_valid()
                    and leaf.fwd_lo >= fwd_term[0]
                    and leaf.fwd_hi <= fwd_term[1]
                )
                is_rvc = (
                    leaf.rvc_valid()
                    and leaf.rvc_lo >= rvc_term[0]
                    and leaf.rvc_hi <= rvc_term[1]
                )
                if is_fwd or is_rvc:
                    s = leaf.full
                    if len(self.trg) > self.min_overlap:
                        s = s + self.trg[i + self.min_overlap:]
                    res = WalkResult(
                        merged_seq=s,
                        sai_coverage=leaf.total_kmer_count,
                        error_rate=leaf.global_err[-1],
                        sa_interval_size=leaf.fwd_hi - leaf.fwd_lo + 1,
                    )
                    if leaf.result_index[0] == -1:
                        results.append(res)
                        leaf.result_index = (len(results), i)
                    else:
                        results[leaf.result_index[0] - 1] = res
                        leaf.result_index = (leaf.result_index[0], i)
                    found = True
                i += 1
        return found
