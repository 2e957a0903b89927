"""Inexact (error-tolerant) all-vs-all overlap: `overlap -e RATE`.

Port of the reference's default LSSF algorithm — a banded FM-index walk
with seed-support pruning:

* driver: OverlapAlgorithm::overlapReadInexactFMWalk
  (Algorithm/OverlapAlgorithm.cpp:149-255) — four search configurations,
  submaximal removal, substring classification, list splicing;
* per-configuration walk: findOverlapBlocksInexactFMIndexWalk
  (Algorithm/OverlapAlgorithm.cpp:982-1040) over SAIOverlapTree
  (FMIndexWalk/SAIOverlapTree.cpp) — root seeding with error-tolerant
  offset scan (:41-78), per-base 4-way left extension (:395-418), the
  seed-support prune (:228-351), '$' termination with right-extreme
  collection (:447-524, :765-817) and containment/substring terminal
  classification (:527-664);
* node state: SAIOverlapNode (FMIndexWalk/SAINode.h:194-233);
* block emission: the 7-arg OverlapBlock ctor (Algorithm/OverlapBlock.h:106)
  with numInsertion/numDeletion; isTargetSubstring blocks are dropped at
  hit-writing time (Concurrency/OverlapProcess.cpp:52).

Error accounting is double arithmetic in the reference; python floats are
IEEE doubles, so computeErrorRate (:371-392) and the totalErrors
truncation (:476) are replicated exactly.

The canonical PacBio hybrid assembly pipeline runs `overlap -m 749 -e 0.05`
(PBHybridCAssembly.sh:28); this module is what that flag dispatches to
(StriDe/overlap.cpp:191-192, errorRate >= 0 selects the inexact engine,
m_algorithm "LSSF" by default).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import alphabet as ab
from .overlap import (
    OverlapBlock, SUF_PRE_AF, PRE_PRE_AF, SUF_SUF_AF, PRE_SUF_AF, _Pair,
    _init_pair, _update_both_l, _update_both_r, _occ_all, _has_dna_ext,
    remove_submaximal_blocks,
)

# SAIOverlapTree defaults (SAIOverlapTree.h:24-32)
MAX_LEAVES = 256
SEED_SIZE = 17
SEED_DIST = 1
REPEAT_FREQ = 256


@dataclass
class _Node:
    """SAIOverlapNode (FMIndexWalk/SAINode.h:194-233)."""

    pair: _Pair
    last_seed_idx: int = 0
    last_overlap_len: int = 0
    total_seeds: int = 0
    curr_overlap_len: int = 0
    num_errors: int = 0
    last_seed_idx_offset: int = 0
    init_seed_idx: int = 0
    query_overlap_len: int = 0


def _find_interval(fm, word: np.ndarray):
    """findInterval (backward search, last char first) on one BWT."""
    k = len(word)
    lo, hi = fm.init_interval(np.int64(word[k - 1]))
    lo, hi = int(lo), int(hi)
    for j in range(k - 2, -1, -1):
        if lo > hi:
            break
        sym = np.int64(word[j])
        pb = int(fm.pc(sym))
        l = int(fm.occ(sym, np.int64(lo - 1)))
        u = int(fm.occ(sym, np.int64(hi)))
        lo, hi = pb + l, pb + u - 1
    return lo, hi


def _find_interval_pair(fmA, fmB, word: np.ndarray) -> _Pair:
    """findIntervalPair: backward search keeping both intervals in sync."""
    k = len(word)
    pair = _init_pair(fmA, fmB, int(word[k - 1]))
    for j in range(k - 2, -1, -1):
        _update_both_l(pair, int(word[j]), fmA)
    return pair


class SAIOverlapTree:
    """FMIndexWalk/SAIOverlapTree.cpp, host engine."""

    def __init__(self, query_enc: np.ndarray, min_overlap: int,
                 max_indel: int, fmA, fmB, flags, error_rate: float,
                 max_leaves: int = MAX_LEAVES, seed_size: int = SEED_SIZE,
                 seed_dist: int = SEED_DIST, repeat_freq: int = REPEAT_FREQ):
        self.q = query_enc
        self.min_overlap = min_overlap
        self.max_indel = max_indel
        self.fmA = fmA
        self.fmB = fmB
        self.flags = flags
        self.error_rate = error_rate
        self.max_leaves = max_leaves
        self.seed_size = seed_size
        self.seed_dist = seed_dist
        self.repeat_freq = repeat_freq
        self.leaves: list[_Node] = []
        self.current_length = 0
        self.terminated: list[tuple[int, int]] = []

        L = len(query_enc)
        # error-tolerant root scan (SAIOverlapTree.cpp:41-78)
        for off in range(seed_size + max_indel):
            if off + seed_size > L:
                break
            seed = query_enc[L - seed_size - off : L - off]
            bip = _find_interval_pair(fmA, fmB, seed)
            if bip.valid0() and bip.valid1() and (bip.hi0 - bip.lo0 + 1) < repeat_freq:
                root = _Node(pair=bip)
                root.last_overlap_len = root.curr_overlap_len = \
                    root.query_overlap_len = self.current_length = seed_size + off
                root.last_seed_idx = root.init_seed_idx = off
                root.total_seeds = 1
                self.leaves.append(root)
                # seeding SA intervals, rightmost first (:70-74)
                for i in range(L - seed_size, -1, -seed_dist):
                    self.terminated.append(
                        _find_interval(fmA, query_enc[i : i + seed_size]))
                break

    # -- per-base machinery -------------------------------------------------
    def _extend_leaves(self) -> None:
        new_leaves = []
        for node in self.leaves:
            exts = []
            for b in range(1, 5):
                probe = node.pair.copy()
                _update_both_l(probe, b, self.fmA)
                if probe.valid0() and probe.valid1():
                    exts.append(probe)
            if len(exts) == 1:
                node.pair = exts[0]
                node.curr_overlap_len += 1
                node.query_overlap_len += 1
                new_leaves.append(node)
            else:
                for p in exts:
                    child = _Node(
                        pair=p, last_seed_idx=node.last_seed_idx,
                        last_overlap_len=node.last_overlap_len,
                        total_seeds=node.total_seeds,
                        curr_overlap_len=node.curr_overlap_len + 1,
                        num_errors=node.num_errors,
                        last_seed_idx_offset=node.last_seed_idx_offset,
                        init_seed_idx=node.init_seed_idx,
                        query_overlap_len=node.query_overlap_len + 1)
                    new_leaves.append(child)
        self.current_length += 1
        self.leaves = new_leaves

    def _add_new_root(self) -> None:
        """addNewRootNodes (:200-224) at current_length == 2*seed_size."""
        L = len(self.q)
        s = self.q[L - self.current_length : L - self.current_length + self.seed_size]
        bip = _find_interval_pair(self.fmA, self.fmB, s)
        if bip.valid0() and bip.valid1() and (bip.hi0 - bip.lo0 + 1) < self.repeat_freq:
            root = _Node(pair=bip)
            root.init_seed_idx = (self.current_length - self.seed_size) // self.seed_dist
            root.last_seed_idx = root.init_seed_idx - 1
            root.last_overlap_len = root.curr_overlap_len = \
                root.query_overlap_len = self.current_length
            root.total_seeds = 1
            self.leaves.append(root)

    def _supported_by_new_seed(self, node: _Node, large_idx: int) -> bool:
        """isSupportedByNewSeed (:302-351)."""
        if node.last_overlap_len < self.current_length - self.seed_size:
            off = self.seed_size // self.seed_dist
        else:
            off = self.current_length - node.last_overlap_len - 1
        for i in range(node.last_seed_idx + off, large_idx + 1):
            t_lo, t_hi = self.terminated[i]
            if node.pair.lo0 >= t_lo and node.pair.hi0 <= t_hi:
                node.last_seed_idx = i
                node.last_overlap_len = self.current_length
                node.curr_overlap_len = self.current_length
                node.query_overlap_len = i * self.seed_dist + self.seed_size
                node.total_seeds += 1
                return True
        return False

    def _prune_by_seed_support(self) -> None:
        """PrunedBySeedSupport (:228-299)."""
        curr_seed_idx = (self.current_length - self.seed_size) // self.seed_dist
        indel_off = (self.seed_size + self.max_indel) // self.seed_dist
        small_idx = 0 if curr_seed_idx <= indel_off else curr_seed_idx - indel_off
        top = len(self.terminated) - 1
        large_idx = top if curr_seed_idx + indel_off >= top else curr_seed_idx + indel_off
        new_leaves = []
        for node in self.leaves:
            in_range = small_idx <= node.last_seed_idx <= large_idx
            found = self._supported_by_new_seed(node, large_idx)
            if found:
                node.last_seed_idx_offset = node.last_seed_idx - curr_seed_idx
            if not found and curr_seed_idx + node.last_seed_idx_offset == node.last_seed_idx + 1:
                node.num_errors += 1
            if in_range or found:
                new_leaves.append(node)
        self.leaves = new_leaves

    def _error_rate(self, node: _Node) -> float:
        """computeErrorRate (:371-392), exact double arithmetic."""
        matched = node.total_seeds * 2 + node.num_errors * (self.seed_size - 1) * 2
        total = node.query_overlap_len + node.curr_overlap_len - self.seed_size * 2 + 2
        return (total - matched) / float(total)

    # -- right-extreme walks (:666-817) --------------------------------------
    def _extend_right_all(self, pairs: list[_Pair]) -> list[_Pair]:
        out = []
        for p in pairs:
            for b in range(1, 5):
                probe = p.copy()
                _update_both_r(probe, b, self.fmB)
                if probe.valid0() and probe.valid1():
                    out.append(probe)
        return out

    def _probe_right_dollar(self, p: _Pair):
        probe = p.copy()
        _update_both_r(probe, 0, self.fmB)
        return probe if probe.valid0() and probe.valid1() else None

    def _probe_left_dollar(self, p: _Pair):
        probe = p.copy()
        _update_both_l(probe, 0, self.fmA)
        return probe if probe.valid0() and probe.valid1() else None

    def _collect_to_right_extreme(self, pair: _Pair, length: int,
                                  terminated_out: list) -> list[_Pair]:
        """collectToRightExtreme (:765-817)."""
        currbips = [pair]
        t = self._probe_right_dollar(pair)
        if t is not None:
            terminated_out.append(t)
        if length == 0:
            return currbips
        for _ in range(length):
            newbips = self._extend_right_all(currbips)
            if not newbips:
                return newbips
            for p in currbips:
                t = self._probe_right_dollar(p)
                if t is not None:
                    terminated_out.append(t)
            currbips = newbips
        return currbips

    def _extend_to_right_extreme(self, pair: _Pair, length: int) -> list[_Pair]:
        """extendToRightExtreme (:720-759)."""
        currbips = [pair]
        if length == 0:
            return currbips
        for _ in range(length):
            newbips = self._extend_right_all(currbips)
            if not newbips:
                return newbips
            currbips = newbips
        return currbips

    def _extend_to_left_extreme(self, pair: _Pair, length: int):
        """extendToLeftExtreme (:667-718); returns (results, isLeftSubstring)."""
        currbips = [pair]
        results: list[_Pair] = []
        for _ in range(length):
            newbips = []
            for p in currbips:
                for b in range(1, 5):
                    probe = p.copy()
                    _update_both_l(probe, b, self.fmA)
                    if probe.valid0() and probe.valid1():
                        newbips.append(probe)
            if not newbips:
                return results, False
            for p in newbips:
                t = self._probe_left_dollar(p)
                if t is not None:
                    results.append(t)
            currbips = newbips
        is_sub = any(_has_dna_ext(self.fmA, p.lo0, p.hi0) for p in currbips)
        return results, is_sub

    # -- termination ----------------------------------------------------------
    def _make_block(self, probed: _Pair, node: _Node, overlap_len: int,
                    total_errors: int, target_substr: bool = False) -> OverlapBlock:
        ins = node.query_overlap_len - self.current_length \
            if node.query_overlap_len >= self.current_length else 0
        dele = self.current_length - node.query_overlap_len \
            if node.query_overlap_len < self.current_length else 0
        return OverlapBlock(
            probed.lo0, probed.hi0, node.pair.lo1, node.pair.hi1,
            overlap_len, self.flags, num_diff=total_errors,
            p_lo1=probed.lo1, p_hi1=probed.hi1,
            num_insertion=ins, num_deletion=dele,
            is_target_substring=target_substr)

    def _is_terminated(self, results: list) -> bool:
        """isTerminated (:447-524)."""
        found = False
        L = len(self.q)
        for node in self.leaves:
            probe = self._probe_left_dollar(node.pair)
            if probe is None:
                continue
            if not (self.min_overlap <= node.query_overlap_len < L):
                continue
            substr_reads: list[_Pair] = []
            normal_reads = self._collect_to_right_extreme(
                probe, node.init_seed_idx, substr_reads)
            err = self._error_rate(node)
            if err >= self.error_rate:
                continue
            total_errors = int(err * L * 2)
            for p in normal_reads:
                results.append(self._make_block(
                    p, node, node.query_overlap_len, total_errors))
                found = True
            for p in substr_reads:
                results.append(self._make_block(
                    p, node, node.query_overlap_len, total_errors,
                    target_substr=True))
                found = True
        return found

    def terminate_contained_blocks(self, results: list) -> bool:
        """terminateContainedBlocks (:527-664); True <=> query is substring."""
        L = len(self.q)
        new_leaves = []
        for node in self.leaves:
            if node.query_overlap_len < L:
                new_leaves.append(node)
                continue
            err = self._error_rate(node)
            if err < self.error_rate:
                ranges = node.pair
                left_has = _has_dna_ext(self.fmA, ranges.lo0, ranges.hi0)
                right_has = _has_dna_ext(self.fmB, ranges.lo1, ranges.hi1)
                total_errors = int(err * L * 2)
                if left_has:
                    right_term = self._extend_to_right_extreme(
                        node.pair, node.init_seed_idx)
                    both_term: list[_Pair] = []
                    for _p in right_term:
                        left_term, is_left_sub = self._extend_to_left_extreme(
                            node.pair, self.max_indel)
                        if is_left_sub:
                            return True
                        both_term.extend(left_term)
                    for p in both_term:
                        results.append(self._make_block(
                            p, node, L + 1, total_errors))
                elif right_has:
                    containments = self._extend_to_right_extreme(
                        node.pair, node.init_seed_idx)
                    for _p1 in containments:
                        probe1 = self._probe_left_dollar(ranges)
                        probe2 = self._probe_right_dollar(ranges)
                        if probe1 is not None and probe2 is not None:
                            results.append(self._make_block(
                                probe1, node, L, total_errors))
                        else:
                            assert probe1 is not None
                            right_terms = self._extend_to_right_extreme(_p1, 1)
                            for _p2 in right_terms:
                                results.append(self._make_block(
                                    probe1, node, L + 1, total_errors))
                else:
                    probe = self._probe_left_dollar(ranges)
                    if probe is not None and node.init_seed_idx == 0:
                        results.append(self._make_block(
                            probe, node, L, total_errors))
        self.leaves = new_leaves
        return False

    def extend_one_base(self, results: list) -> int:
        """extendOverlapOneBase (:93-134)."""
        if (self.leaves and len(self.leaves) <= self.max_leaves
                and self.current_length <= len(self.q) + self.max_indel):
            self._extend_leaves()
            if self.current_length == self.seed_size * 2:
                self._add_new_root()
            self._prune_by_seed_support()
            if self.current_length >= self.min_overlap:
                self._is_terminated(results)
        if not self.leaves:
            return -1
        if self.current_length > len(self.q) + self.max_indel:
            return -2
        if len(self.leaves) > self.max_leaves:
            return -3
        return 1


def find_overlap_blocks_inexact_fmwalk(w_enc: np.ndarray, fmA, fmB, flags,
                                       min_overlap: int, out_blocks: list,
                                       contain_blocks: list,
                                       error_rate: float, max_indel: int):
    """findOverlapBlocksInexactFMIndexWalk (OverlapAlgorithm.cpp:982-1040).

    Returns is_substring for this configuration."""
    tree = SAIOverlapTree(w_enc, min_overlap, max_indel, fmA, fmB, flags,
                          error_rate)
    L = len(w_enc)
    tmp: list[OverlapBlock] = []
    while tree.current_length < L + max_indel:
        if not tree.leaves:
            break
        flag = tree.extend_one_base(tmp)
        if flag == -3:
            return False
        out_blocks.extend(tmp)
        tmp.clear()
        if tree.current_length >= L - max_indel:
            if tree.terminate_contained_blocks(tmp):
                return True
            contain_blocks.extend(tmp)
            tmp.clear()
    return False


def overlap_read_inexact_fmwalk(ix, seq: str, min_overlap: int,
                                error_rate: float, max_indel: int):
    """overlapReadInexactFMWalk (OverlapAlgorithm.cpp:149-255).

    Returns (blocks, is_substring); containments are spliced into the block
    lists (the FMWalk variant keeps them — transitive reduction does not
    apply to indel overlaps, :212-216)."""
    enc = ab.encode(seq)
    if len(seq) < min_overlap:
        return [], False
    rc = ab.reverse_complement(enc)
    comp = np.where(enc == 0, 0, 5 - enc).astype(enc.dtype)
    rev = enc[::-1].copy()

    fwd_contain: list[OverlapBlock] = []
    rev_contain: list[OverlapBlock] = []
    suffix_fwd: list[OverlapBlock] = []
    suffix_rev: list[OverlapBlock] = []
    prefix_fwd: list[OverlapBlock] = []
    prefix_rev: list[OverlapBlock] = []

    for w, fmA, fmB, af, out, contain in (
        (enc, ix.bwt, ix.rbwt, SUF_PRE_AF, suffix_fwd, fwd_contain),
        (comp, ix.rbwt, ix.bwt, PRE_PRE_AF, suffix_rev, rev_contain),
        (rc, ix.bwt, ix.rbwt, SUF_SUF_AF, prefix_fwd, fwd_contain),
        (rev, ix.rbwt, ix.bwt, PRE_SUF_AF, prefix_rev, rev_contain),
    ):
        if find_overlap_blocks_inexact_fmwalk(
                w, fmA, fmB, af, min_overlap, out, contain,
                error_rate, max_indel):
            return [], True

    from dataclasses import replace as _copy

    suffix_fwd += [_copy(b) for b in fwd_contain]
    prefix_fwd += [_copy(b) for b in fwd_contain]
    suffix_rev += [_copy(b) for b in rev_contain]
    prefix_rev += [_copy(b) for b in rev_contain]

    is_substring = False
    out_lists = []
    for lst in (suffix_fwd, prefix_fwd, suffix_rev, prefix_rev):
        lst = remove_submaximal_blocks(lst)
        if any(b.overlap_len > len(seq) for b in lst):
            is_substring = True
        out_lists.append(lst)
    if is_substring:
        return [], True
    suffix_fwd, prefix_fwd, suffix_rev, prefix_rev = out_lists
    # splice order (:249-255): prefixFwd + prefixRev + suffixFwd + suffixRev
    blocks = prefix_fwd + prefix_rev + suffix_fwd + suffix_rev
    # isTargetSubstring blocks are skipped at hit-writing time
    # (Concurrency/OverlapProcess.cpp:52)
    return [b for b in blocks if not b.is_target_substring], False
