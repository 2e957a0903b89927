"""Paired-end FM-walk merge / validate (`stride fmwalk`).

Re-implementation of FMIndexWalk/SAIntervalTree.{h,cpp}: BFS FM-index walk
from the suffix kmer of one read toward the prefix kmer of a second read
(merge), or re-walk of a corrected long read against the index to confirm
minimum-overlap support of every segment (validate).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import alphabet as ab

RANK_CHARS = "$ACGT"


def _find(fm, word: str):
    lo, hi = fm.find_interval(ab.encode(word))
    return int(lo), int(hi)


def _size(lo, hi):
    return hi - lo + 1 if lo <= hi else 0


@dataclass
class _Leaf:
    full: str
    fwd_lo: int
    fwd_hi: int
    rvc_lo: int
    rvc_hi: int
    kmer_count: int = 0


class SAIntervalTree:
    """One PE-merge / validation walk (SAIntervalTree.cpp:20-120)."""

    def __init__(self, ix, query: str, min_overlap: int, max_overlap: int,
                 max_length: int, max_leaves: int, second_read: str = "",
                 sa_threshold: int = 1, kmer_mode: bool = False,
                 from_prefix: bool = False):
        self.ix = ix
        self.query = query
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.max_length = max_length
        self.max_leaves = max_leaves
        self.second = second_read
        self.threshold = sa_threshold
        self.kmer_mode = kmer_mode
        self.max_kmer_coverage = 0
        self.max_used_leaves = 0
        self.bubble_collapsed = False

        if not from_prefix:
            root_str = query
            beginning = query[len(query) - min_overlap:]
            ending = second_read[:min_overlap]
        else:
            # validate-style root: walk from the query prefix to its suffix
            # (2nd constructor, SAIntervalTree.cpp:59-95)
            root_str = query[:min_overlap]
            beginning = root_str
            ending = query[len(query) - min_overlap:]

        f = _find(ix.rbwt, beginning[::-1])
        r = _find(ix.bwt, ab.revcomp_str(beginning))
        self.leaves = [_Leaf(root_str, f[0], f[1], r[0], r[1])]
        self.current_length = len(root_str)
        self.current_kmer_size = min_overlap
        self.fwd_term = _find(ix.rbwt, ending[::-1])
        self.rvc_term = _find(ix.bwt, ab.revcomp_str(ending))

    # ------------------------------------------------------------------
    def merge_two_reads(self) -> tuple[int, str]:
        """mergeTwoReads (:103-170)."""
        direct = self._is_two_reads_overlap()
        if direct is not None:
            return 1, direct
        return self._walk()

    def validate(self) -> tuple[int, str]:
        """validate (:173-240): same walk, no direct-overlap shortcut."""
        return self._walk()

    def _walk(self) -> tuple[int, str]:
        results = []
        while self.leaves and len(self.leaves) <= self.max_leaves and \
                self.current_length <= self.max_length:
            self._extend_leaves()
            if len(self.leaves) > self.max_used_leaves:
                self.max_used_leaves = len(self.leaves)
            if self._is_terminated(results):
                break

        if results:
            if len(results) == len(self.leaves):
                self.bubble_collapsed = True
            merged = ""
            for thread, _cov in results:
                if len(self.second) > self.min_overlap:
                    tmp = thread + self.second[self.min_overlap:]
                else:
                    tmp = thread
                cov = self._kmer_coverage(tmp, self.min_overlap)
                if cov > self.max_kmer_coverage:
                    merged = tmp
                    self.max_kmer_coverage = cov
            return 1, merged
        if not self.leaves:
            return -1, ""
        if self.current_length > self.max_length:
            return -2, ""
        if len(self.leaves) > self.max_leaves:
            return -3, ""
        return -4, ""

    # ------------------------------------------------------------------
    def _extend_leaves(self) -> None:
        new_leaves = self._attempt_to_extend()
        if not self.kmer_mode and not new_leaves:
            self._refine_sa_interval(self.min_overlap)
            new_leaves = self._attempt_to_extend()
        if new_leaves:
            self.current_kmer_size += 1
            self.current_length += 1
        self.leaves = new_leaves
        if self.leaves and (self.kmer_mode or self.current_kmer_size >= self.max_overlap):
            self._refine_sa_interval(self.min_overlap)

    def _attempt_to_extend(self) -> list[_Leaf]:
        out = []
        for leaf in self.leaves:
            exts = self._fm_extensions(leaf)
            if len(exts) == 1:
                ch, f_lo, f_hi, r_lo, r_hi = exts[0]
                leaf.full += ch
                leaf.fwd_lo, leaf.fwd_hi, leaf.rvc_lo, leaf.rvc_hi = f_lo, f_hi, r_lo, r_hi
                leaf.kmer_count += _size(f_lo, f_hi) + _size(r_lo, r_hi)
                out.append(leaf)
            else:
                for (ch, f_lo, f_hi, r_lo, r_hi) in exts:
                    child = _Leaf(leaf.full + ch, f_lo, f_hi, r_lo, r_hi,
                                  leaf.kmer_count + _size(f_lo, f_hi) + _size(r_lo, r_hi))
                    out.append(child)
        return out

    def _fm_extensions(self, leaf: _Leaf):
        out = []
        for i in range(1, 5):
            b = RANK_CHARS[i]
            f_lo, f_hi = leaf.fwd_lo, leaf.fwd_hi
            if f_lo <= f_hi:
                f_lo, f_hi = (int(x) for x in self.ix.rbwt.update_interval(f_lo, f_hi, i))
            r_lo, r_hi = leaf.rvc_lo, leaf.rvc_hi
            if r_lo <= r_hi:
                r_lo, r_hi = (int(x) for x in self.ix.bwt.update_interval(r_lo, r_hi, 5 - i))
            bcount = _size(f_lo, f_hi) + _size(r_lo, r_hi)
            if bcount >= self.threshold:
                out.append((b, f_lo, f_hi, r_lo, r_hi))
        return out

    def _refine_sa_interval(self, new_k: int) -> None:
        for leaf in self.leaves:
            reduced = leaf.full[len(leaf.full) - new_k:]
            leaf.fwd_lo, leaf.fwd_hi = _find(self.ix.rbwt, reduced[::-1])
            leaf.rvc_lo, leaf.rvc_hi = _find(self.ix.bwt, ab.revcomp_str(reduced))
        self.current_kmer_size = new_k

    def _is_terminated(self, results) -> bool:
        found = False
        for leaf in self.leaves:
            fwd_ok = (
                leaf.fwd_lo <= leaf.fwd_hi
                and leaf.fwd_lo >= self.fwd_term[0]
                and leaf.fwd_hi <= self.fwd_term[1]
            )
            rvc_ok = (
                leaf.rvc_lo <= leaf.rvc_hi
                and leaf.rvc_lo >= self.rvc_term[0]
                and leaf.rvc_hi <= self.rvc_term[1]
            )
            if fwd_ok or rvc_ok:
                results.append((leaf.full, leaf.kmer_count))
                found = True
        return found

    # ------------------------------------------------------------------
    def _is_two_reads_overlap(self) -> str | None:
        """isTwoReadsOverlap (:352-395)."""
        q, second, mo = self.query, self.second, self.min_overlap
        root = self.leaves[0]
        if (root.fwd_lo, root.fwd_hi) == self.fwd_term:
            return q + second[mo:]
        second_left = second[:mo]
        start = len(q) - 200 if len(q) >= 200 else 0
        pos = q.find(second_left, start)
        if pos != -1 and q[pos:] == second[: len(q) - pos]:
            return q[:pos] + second
        if self.kmer_mode:
            return None
        first_left = q[:mo]
        pos = second.find(first_left)
        if pos != -1 and pos <= 50 and second[pos:] == q[: len(second) - pos]:
            return second[pos:]
        return None

    def _kmer_coverage(self, seq: str, k: int) -> int:
        """calculateKmerCoverage (:442-451)."""
        if len(seq) < k:
            return 0
        cov = 0
        i = 0
        while i <= len(seq) - k:
            cov += self.ix.bwt.count_occurrences_both_strands(ab.encode(seq[i : i + k]))
            i += k // 2
        return cov


def merge_pair(ix, read1: str, read2_rc: str, min_overlap: int, max_overlap: int,
               max_insert: int, max_leaves: int = 32, sa_threshold: int = 1):
    """Merge a PE pair (read2 already reverse-complemented into read1's
    orientation), FMIndexWalkProcess::MergeAndKmerize walk portion."""
    tree = SAIntervalTree(
        ix, read1, min_overlap, max_overlap, max_insert, max_leaves,
        second_read=read2_rc, sa_threshold=sa_threshold,
    )
    return tree.merge_two_reads()


def validate_read(ix, seq: str, min_overlap: int, max_leaves: int = 256,
                  sa_threshold: int = 1, max_overlap: int = -1):
    """Re-walk a corrected read to confirm min-overlap support
    (`fmwalk -a validate`, FMIndexWalkProcess.cpp:295-312: maxOverlap caps at
    90% of length, search depth 1.1x length, empty second read)."""
    mo = max_overlap if max_overlap != -1 else int(len(seq) * 0.9)
    tree = SAIntervalTree(
        ix, seq, min_overlap, mo, int(len(seq) * 1.1), max_leaves,
        second_read="", sa_threshold=sa_threshold, from_prefix=True,
    )
    return tree.validate()


# ---------------------------------------------------------------------------
# kmerize / hybrid (MergeAndKmerize) — FMIndexWalkProcess.cpp:29-150,229-267
# ---------------------------------------------------------------------------

def _count_both(ix, word: str) -> int:
    """countSequenceOccurrences: both-strand count."""
    codes = ab.encode(word)
    lo1, hi1 = ix.bwt.find_interval(codes)
    lo2, hi2 = ix.bwt.find_interval(ab.reverse_complement(codes))
    return max(int(hi1) - int(lo1) + 1, 0) + max(int(hi2) - int(lo2) + 1, 0)


def _count_single(ix, codes: np.ndarray) -> int:
    """countSequenceOccurrencesSingleStrand."""
    lo, hi = ix.bwt.find_interval(codes)
    return max(int(hi) - int(lo) + 1, 0)


def num_next_kmer(ix, kmer: str, start_dir: bool, threshold: int = 1) -> int:
    """numNextKmer (FMIndexWalkProcess.cpp:855-870): how many of the four
    shifted kmers have both-strand count >= threshold."""
    n = 0
    for b in "ATCG":
        nxt = (b + kmer[:-1]) if start_dir else (kmer[1:] + b)
        if _count_both(ix, nxt) >= threshold:
            n += 1
    return n


def trim_read(ix, seq: str, k: int) -> str:
    """trimRead (:825-853): trim dead-end heads/tails to the first >=2-way
    branching kmer."""
    head, tail = 0, len(seq) - k
    if tail < 0:
        return seq
    if num_next_kmer(ix, seq[head : head + k], True, 1) == 0:
        head += 1
        while head <= tail:
            if num_next_kmer(ix, seq[head : head + k], True, 1) >= 2:
                break
            head += 1
    if head <= tail and num_next_kmer(ix, seq[tail : tail + k], False, 1) == 0:
        tail -= 1
        while tail >= head:
            if num_next_kmer(ix, seq[tail : tail + k], False, 1) >= 2:
                break
            tail -= 1
    if head > tail:
        return ""
    return seq[head : tail + k]


def kmer_context(ix, seq: str, k: int):
    """KmerContext (FMIndexWalkProcess.h:61-100): per-window single-strand
    frequencies, vectorised."""
    n = len(seq) - k + 1
    if n <= 0:
        return None
    enc = ab.encode(seq)
    win = np.lib.stride_tricks.sliding_window_view(enc, k)[:n]
    lo, hi = ix.bwt.find_interval(win)
    same = np.maximum(hi - lo + 1, 0)
    rc = ab.complement(win)[:, ::-1]
    lo, hi = ix.bwt.find_interval(rc)
    revc = np.maximum(hi - lo + 1, 0)
    return same.astype(np.int64), revc.astype(np.int64)


def _is_simple(ix, lkmer: str, rkmer: str) -> bool:
    """isSimple (:851-860 header): both boundary kmers have exactly one
    continuation."""
    return (num_next_kmer(ix, lkmer, False, 1) == 1
            and num_next_kmer(ix, rkmer, True, 1) == 1)


def split_read(ix, seq: str, k: int, threshold: int):
    """splitRead (:555-608) -> (main_idx, pieces)."""
    ctx = kmer_context(ix, seq, k)
    if ctx is None:
        return -1, []
    same, revc = ctx
    nk = len(same)
    qualified = (same >= threshold).astype(int) + (revc >= threshold).astype(int)
    intervals = []
    start = 0
    for p in range(1, nk):
        if qualified[p - 1] == 2 and qualified[p] == 2:
            continue
        if not _is_simple(ix, seq[p - 1 : p - 1 + k], seq[p : p + k]):
            intervals.append((start, p - 1))
            start = p
    intervals.append((start, nk - 1))
    max_num = 0
    main_idx = -1
    pieces = []
    for i, (s, e) in enumerate(intervals):
        if np.any(qualified[s : e + 1] == 2):
            num = e - s
            if max_num < num:
                max_num = num
                main_idx = i
        pieces.append(seq[s : e + k])
    return main_idx, pieces


def _is_low_complexity_fmw(seq: str) -> bool:
    """FMIndexWalkProcess::isLowComplexity (:418-445)."""
    n = len(seq)
    return any(seq.count(c) / n >= 0.9 for c in "ATCG")


def _max_con(s: str) -> int:
    """maxCon (:448-478): longest homopolymer run (N skipped)."""
    best = c = 1
    for i in range(1, len(s)):
        if s[i] == "N":
            continue
        if s[i] != s[i - 1]:
            best = max(best, c)
            c = 1
        else:
            c += 1
            best = max(best, c)
    return best


def kmerize_read(ix, seq: str, k: int, threshold: int):
    """KmerizeReads (:229-267) -> (kmerize, main_piece, other_pieces)."""
    if len(seq) < k:
        return False, "", []
    main_idx, pieces = split_read(ix, seq, k, threshold)
    if not pieces:
        return False, "", []
    main = ""
    others = []
    for i, p in enumerate(pieces):
        if i == main_idx:
            main = p
        else:
            others.append(p)
    return True, main, others


def merge_and_kmerize(ix, seq1: str, seq2: str, k: int, threshold: int,
                      min_overlap: int, max_overlap: int, max_insert: int,
                      max_leaves: int, repeat_freq: float):
    """MergeAndKmerize (:29-150) — the FMW_HYBRID per-pair process.

    seq2 must already be the second read as stored (NOT reverse-complemented;
    the walk itself reverse-complements the target).
    Returns dict(merge, seq, kmerize, main1, others1, kmerize2, main2,
    others2)."""
    out = dict(merge=False, seq="", kmerize=False, main1="", others1=[],
               kmerize2=False, main2="", others2=[])
    t1 = trim_read(ix, seq1, k)
    t2 = trim_read(ix, seq2, k)
    if (min(len(t1), len(t2)) >= k
            and (len(t1) <= min_overlap or len(t2) <= min_overlap)):
        out["kmerize"] = out["kmerize2"] = True
        out["main1"], out["main2"] = t1, t2
        return out
    if len(t1) < k or len(t2) < k:
        return out

    first = t1[:min_overlap]
    second = t2[:min_overlap]
    suitable = (len(first) >= min_overlap and len(second) >= min_overlap
                and _count_both(ix, first) < repeat_freq
                and _count_both(ix, second) < repeat_freq)
    if suitable:
        # the MergeAndKmerize walks use the ctor-default SA threshold 3
        # (SAIntervalTree.h:29) — NOT the kmerize threshold
        tree1 = SAIntervalTree(ix, first, min_overlap, max_overlap,
                               max_insert, max_leaves,
                               second_read=ab.revcomp_str(second),
                               sa_threshold=3)
        code1, m1 = tree1.merge_two_reads()
        tree2 = SAIntervalTree(ix, second, min_overlap, max_overlap,
                               max_insert, max_leaves,
                               second_read=ab.revcomp_str(first),
                               sa_threshold=3)
        code2, m2 = tree2.merge_two_reads()
        if m1 and not m2 and tree1.max_used_leaves <= 1 and tree2.max_used_leaves <= 1:
            out["merge"] = True
            out["seq"] = m1
            return out
        if not m1 and m2 and tree2.max_used_leaves <= 1 and tree1.max_used_leaves <= 1:
            out["merge"] = True
            out["seq"] = m2
            return out
        if m1 and m2 and m1 == ab.revcomp_str(m2):
            out["merge"] = True
            out["seq"] = m1 if tree1.max_kmer_coverage > tree2.max_kmer_coverage else m2
            return out

    for tag, t in (("", t1), ("2", t2)):
        if len(t) < k:
            continue
        main_idx, pieces = split_read(ix, t, k, threshold)
        if pieces:
            out["kmerize" + tag] = True
        kept_main = ""
        others = []
        for i, p in enumerate(pieces):
            if _is_low_complexity_fmw(p):
                continue
            if _max_con(p) * 3 > len(p):
                continue
            if i == main_idx:
                kept_main = p
            else:
                others.append(p)
        out["main1" if not tag else "main2"] = kept_main
        out["others1" if not tag else "others2"] = others
    return out
