"""All-vs-all exact overlap discovery on the FM-index (`stride overlap`).

Re-implements the reference's exhaustive exact mode:

* per read, four backward searches collect prefix/suffix overlap blocks on
  both strands (OverlapAlgorithm::overlapReadExact,
  Algorithm/OverlapAlgorithm.cpp:270-346; search configs :290-295 with
  AlignFlags :14-17);
* findOverlapBlocksExact (:417-487): '$'-probed interval per significant
  suffix length, substring detection via extension counts, containment
  blocks;
* TrimOBLInterval (:349-395) interval cap — replicated as written (the
  accumulation walks from the shortest block);
* removeSubMaximalBlocks / resolveOverlap (Algorithm/OverlapBlock.cpp);
* block -> edge conversion through the lexicographic index
  (OverlapCommon::parseHitsString, StriDe/OverlapCommon.cpp:16-77).

Both output modes are implemented: the exhaustive mode (`overlap -x`)
and the irreducible-only mode (compute_irreducible_blocks below, the
semantics of OverlapAlgorithm::computeIrreducibleBlocks); assemble's
transitive-reduction pass removes the same edges either way
(StriDe/assemble.cpp:199-203).

Interval-pair updates follow BWTAlgorithms::updateBothL/R
(SuffixTools/BWTAlgorithms.h:81-132).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import alphabet as ab
from .core import Match, Overlap, SeqCoord

# AlignFlags(queryRev, targetRev, queryComp) per search config
SUF_PRE_AF = (False, False, False)
PRE_PRE_AF = (False, True, True)
SUF_SUF_AF = (True, False, True)
PRE_SUF_AF = (True, True, False)


@dataclass
class OverlapBlock:
    lo: int            # ranges.interval[0] of the '$'-probed pair (lex ranks)
    hi: int
    raw1_lo: int       # rawRanges.interval[1] (used by TrimOBLInterval)
    raw1_hi: int
    overlap_len: int
    flags: tuple       # (query_rev, target_rev, query_comp)
    num_diff: int = 0
    # '$'-probed pair interval[1] — live range for right-extension in the
    # irreducible classification (OverlapBlock::ranges)
    p_lo1: int = 0
    p_hi1: int = -1
    # indel accounting of the inexact engine (OverlapBlock.h:106-121)
    num_insertion: int = 0
    num_deletion: int = 0
    is_target_substring: bool = False

    def interval1_size(self) -> int:
        return max(self.raw1_hi - self.raw1_lo + 1, 0)


class _Pair:
    """BWTIntervalPair: interval[0] on fmA, interval[1] on fmB."""

    __slots__ = ("lo0", "hi0", "lo1", "hi1")

    def __init__(self, lo0, hi0, lo1, hi1):
        self.lo0, self.hi0, self.lo1, self.hi1 = int(lo0), int(hi0), int(lo1), int(hi1)

    def copy(self):
        return _Pair(self.lo0, self.hi0, self.lo1, self.hi1)

    def valid0(self):
        return self.lo0 <= self.hi0

    def valid1(self):
        return self.lo1 <= self.hi1


def _occ_all(fm, idx: int) -> np.ndarray:
    syms = np.arange(5, dtype=np.int64)
    return fm.occ(syms, np.full(5, idx, np.int64))


def _init_pair(fmA, fmB, sym: int) -> _Pair:
    loA, hiA = fmA.init_interval(np.int64(sym))
    loB, hiB = fmB.init_interval(np.int64(sym))
    return _Pair(loA, hiA, loB, hiB)


def _update_both_l(pair: _Pair, sym: int, fmA) -> None:
    """Prepend sym: interval[0] via fmA occ; interval[1] via occ diffs
    (BWTAlgorithms.h:109-132)."""
    l = _occ_all(fmA, pair.lo0 - 1)
    u = _occ_all(fmA, pair.hi0)
    diff = u - l
    less = int(diff[:sym].sum())
    pair.lo1 = pair.lo1 + less
    pair.hi1 = pair.lo1 + int(diff[sym]) - 1
    pb = int(fmA.pc(np.int64(sym)))
    pair.lo0 = pb + int(l[sym])
    pair.hi0 = pb + int(u[sym]) - 1


def _update_both_r(pair: _Pair, sym: int, fmB) -> None:
    """Append sym: interval[1] via fmB occ; interval[0] via diffs
    (BWTAlgorithms.h:81-106)."""
    l = _occ_all(fmB, pair.lo1 - 1)
    u = _occ_all(fmB, pair.hi1)
    diff = u - l
    less = int(diff[:sym].sum())
    pair.lo0 = pair.lo0 + less
    pair.hi0 = pair.lo0 + int(diff[sym]) - 1
    pb = int(fmB.pc(np.int64(sym)))
    pair.lo1 = pb + int(l[sym])
    pair.hi1 = pb + int(u[sym]) - 1


def _has_dna_ext(fm, lo: int, hi: int) -> bool:
    if lo > hi:
        return False
    l = _occ_all(fm, lo - 1)
    u = _occ_all(fm, hi)
    return bool(((u - l)[1:5] > 0).any())


def find_overlap_blocks_exact(w_enc: np.ndarray, fmA, fmB, flags: tuple,
                              min_overlap: int, out_blocks: list,
                              contain_blocks: list) -> bool:
    """findOverlapBlocksExact (OverlapAlgorithm.cpp:417-487).

    Returns is_substring for this search configuration."""
    l = len(w_enc)
    pair = _init_pair(fmA, fmB, int(w_enc[l - 1]))
    for i in range(l - 2, 0, -1):
        _update_both_l(pair, int(w_enc[i]), fmA)
        overlap_len = l - i
        if overlap_len >= min_overlap:
            probe = pair.copy()
            _update_both_l(probe, 0, fmA)
            if probe.valid1():
                out_blocks.append(OverlapBlock(
                    probe.lo0, probe.hi0, pair.lo1, pair.hi1, overlap_len, flags,
                    p_lo1=probe.lo1, p_hi1=probe.hi1))
    _update_both_l(pair, int(w_enc[0]), fmA)
    # containment / substring classification on the full-read interval
    if _has_dna_ext(fmA, pair.lo0, pair.hi0) or _has_dna_ext(fmB, pair.lo1, pair.hi1):
        return True
    probe = pair.copy()
    _update_both_l(probe, 0, fmA)
    if probe.valid0() and probe.valid1():
        _update_both_r(probe, 0, fmB)
        contain_blocks.append(OverlapBlock(
            probe.lo0, probe.hi0, pair.lo1, pair.hi1, l, flags))
    return False


def trim_obl_interval(blocks: list, read_len: int) -> None:
    """TrimOBLInterval (OverlapAlgorithm.cpp:349-395), replicated as
    written: sort by overlapLen descending, accumulate interval[1] sizes
    from the back (shortest), erase [0..cut] when >= 128 reads accumulate."""
    if not blocks:
        return
    blocks.sort(key=lambda b: -b.overlap_len)
    shortest = blocks[-1].overlap_len
    acc = 0
    for idx in range(len(blocks) - 1, 0, -1):
        acc += blocks[idx].interval1_size()
        if acc >= 128 or (shortest - blocks[idx].overlap_len >= read_len * 0.5):
            del blocks[: idx + 1]
            return


def _is_intersecting(a_lo, a_hi, b_lo, b_hi) -> bool:
    return not (a_hi < b_lo or b_hi < a_lo)


def remove_submaximal_blocks(blocks: list) -> list:
    """removeSubMaximalBlocks + resolveOverlap (OverlapBlock.cpp): make the
    '$'-probed rank ranges disjoint, preferring lower-error then longer
    blocks."""
    blocks = sorted(blocks, key=lambda b: b.lo)
    i = 0
    while i + 1 < len(blocks):
        a, b = blocks[i], blocks[i + 1]
        if not _is_intersecting(a.lo, a.hi, b.lo, b.hi):
            i += 1
            continue
        if a.num_diff < b.num_diff or (a.num_diff == b.num_diff
                                       and a.overlap_len > b.overlap_len):
            better, worse = a, b
        else:
            better, worse = b, a
        resolved = [better]
        dup_lo = max(better.lo, worse.lo)
        dup_hi = min(better.hi, worse.hi)
        dup_size = dup_hi - dup_lo + 1
        if (better.hi - better.lo + 1) != dup_size:
            if better.lo < worse.lo:
                worse.lo += dup_size
            else:
                worse.hi -= dup_size
            if worse.lo <= worse.hi:
                resolved.append(worse)
        del blocks[i : i + 2]
        blocks.extend(resolved)
        blocks.sort(key=lambda b: b.lo)
        i = 0
    return blocks


def _ext_bwt(ix, block: OverlapBlock):
    """getExtensionBWT (OverlapBlock.cpp): the index for right-extension of
    interval[1] — global RBWT for fwd-target blocks, BWT for rev-target."""
    return ix.bwt if block.flags[1] else ix.rbwt


def _canonical_ext_count(ix, block: OverlapBlock) -> np.ndarray:
    """getCanonicalExtCount: right-extension AlphaCount in query orientation."""
    fm = _ext_bwt(ix, block)
    if block.p_lo1 > block.p_hi1:
        return np.zeros(5, np.int64)
    l = _occ_all(fm, block.p_lo1 - 1)
    u = _occ_all(fm, block.p_hi1)
    out = u - l
    if block.flags[2]:  # queryComp: complement the DNA counts
        out = np.concatenate([out[:1], out[1:5][::-1]])
    return out


def _update_block_right(ix, block: OverlapBlock, canonical_base: int) -> bool:
    """updateOverlapBlockRangesRight for one block; returns validity."""
    fm = _ext_bwt(ix, block)
    rel = canonical_base
    if block.flags[2] and canonical_base != 0:  # comp('$') == '$'
        rel = 5 - canonical_base
    pair = _Pair(block.lo, block.hi, block.p_lo1, block.p_hi1)
    _update_both_r(pair, rel, fm)
    block.lo, block.hi = pair.lo0, pair.hi0
    block.p_lo1, block.p_hi1 = pair.lo1, pair.hi1
    return pair.valid0() and pair.valid1()


def compute_irreducible_blocks(ix, blocks: list) -> list:
    """_processIrreducibleBlocksExactIterative
    (Algorithm/OverlapAlgorithm.cpp:1060-1190): lockstep right-extension of
    block groups; a group's top-level block is irreducible when it reaches
    its read's '$'; shorter blocks still alive then are transitive and are
    dropped; divergent extensions split the group."""
    if not blocks:
        return []
    final: list[OverlapBlock] = []
    groups = [sorted(blocks, key=lambda b: -b.overlap_len)]
    while groups:
        incoming = []
        remaining = []
        for cur in groups:
            top_len = cur[0].overlap_len
            tlb = [b for b in cur if b.overlap_len == top_len]
            ext = sum((_canonical_ext_count(ix, b) for b in tlb),
                      np.zeros(5, np.int64))
            split = False
            if ext[0] > 0:
                ok = True
                appended = 0
                for b in tlb:
                    if _canonical_ext_count(ix, b)[0] == 0:
                        # substring among top-level blocks: undo + split
                        del final[len(final) - appended:]
                        ok = False
                        break
                    nb = OverlapBlock(**{f: getattr(b, f) for f in (
                        "lo", "hi", "raw1_lo", "raw1_hi", "overlap_len",
                        "flags", "num_diff", "p_lo1", "p_hi1")})
                    _update_block_right(ix, nb, 0)
                    final.append(nb)
                    appended += 1
                if ok:
                    continue  # group finished
                split = True
            if not split:
                for b in cur[len(tlb):]:
                    ext = ext + _canonical_ext_count(ix, b)
                dna = ext[1:5]
                if (dna > 0).sum() == 1:
                    base = int(np.argmax(dna)) + 1
                    cur = [b for b in cur if _update_block_right(ix, b, base)]
                    if cur:
                        remaining.append(cur)
                    continue
            # branch: split the group per extension base
            full_ext = sum((_canonical_ext_count(ix, b) for b in cur),
                           np.zeros(5, np.int64))
            for base in range(1, 5):
                if full_ext[base] > 0:
                    branched = []
                    for b in cur:
                        nb = OverlapBlock(**{f: getattr(b, f) for f in (
                            "lo", "hi", "raw1_lo", "raw1_hi", "overlap_len",
                            "flags", "num_diff", "p_lo1", "p_hi1")})
                        if _update_block_right(ix, nb, base):
                            branched.append(nb)
                    if branched:
                        incoming.append(branched)
        groups = remaining + incoming
    return final


def overlap_read_exact(ix, seq: str, min_overlap: int, irreducible: bool = False):
    """overlapReadExact (OverlapAlgorithm.cpp:270-346).

    Returns (blocks, contain_blocks, is_substring).  With irreducible=True
    the transitive blocks are removed by lockstep right-extension
    (computeIrreducibleBlocks, :334-335)."""
    enc = ab.encode(seq)
    rc = ab.reverse_complement(enc)
    comp = np.where(enc == 0, 0, 5 - enc).astype(enc.dtype)
    rev = enc[::-1].copy()
    is_substring = False
    fwd_contain, rev_contain = [], []
    suffix_fwd, suffix_rev, prefix_fwd, prefix_rev = [], [], [], []
    is_substring |= find_overlap_blocks_exact(
        enc, ix.bwt, ix.rbwt, SUF_PRE_AF, min_overlap, suffix_fwd, fwd_contain)
    is_substring |= find_overlap_blocks_exact(
        comp, ix.rbwt, ix.bwt, PRE_PRE_AF, min_overlap, suffix_rev, rev_contain)
    is_substring |= find_overlap_blocks_exact(
        rc, ix.bwt, ix.rbwt, SUF_SUF_AF, min_overlap, prefix_fwd, fwd_contain)
    is_substring |= find_overlap_blocks_exact(
        rev, ix.rbwt, ix.bwt, PRE_SUF_AF, min_overlap, prefix_rev, rev_contain)

    for lst in (suffix_fwd, suffix_rev, prefix_fwd, prefix_rev):
        trim_obl_interval(lst, len(seq))

    from dataclasses import replace as _copy

    # the reference splices VALUE copies of the contain blocks into the
    # suffix/prefix lists; resolution below must not mutate the originals
    suffix_fwd += [_copy(b) for b in fwd_contain]
    prefix_fwd += [_copy(b) for b in fwd_contain]
    suffix_rev += [_copy(b) for b in rev_contain]
    prefix_rev += [_copy(b) for b in rev_contain]
    suffix_fwd = remove_submaximal_blocks(suffix_fwd)
    prefix_fwd = remove_submaximal_blocks(prefix_fwd)
    suffix_rev = remove_submaximal_blocks(suffix_rev)
    prefix_rev = remove_submaximal_blocks(prefix_rev)

    def drop_contain(lst):
        return [b for b in lst if b.overlap_len != len(seq)]

    suffix_all = drop_contain(suffix_fwd) + drop_contain(suffix_rev)
    prefix_all = drop_contain(prefix_fwd) + drop_contain(prefix_rev)
    if irreducible:
        suffix_all = compute_irreducible_blocks(ix, suffix_all)
        prefix_all = compute_irreducible_blocks(ix, prefix_all)
    blocks = suffix_all + prefix_all
    return blocks, fwd_contain + rev_contain, is_substring


def block_to_overlaps(block: OverlapBlock, query_id: str, query_len: int,
                      lex_fwd: np.ndarray, lex_rev: np.ndarray,
                      read_ids: list, read_lens: list) -> list:
    """parseHitsString + OverlapBlock::toOverlap
    (StriDe/OverlapCommon.cpp:16-77, Algorithm/OverlapBlock.cpp)."""
    q_rev, t_rev, _q_comp = block.flags
    lex = lex_rev if t_rev else lex_fwd
    out = []
    for j in range(block.lo, block.hi + 1):
        target = int(lex[j])
        target_id = read_ids[target]
        if target_id == query_id:
            continue
        target_len = read_lens[target]
        ol = block.overlap_len
        sc1 = SeqCoord(query_len - ol, query_len - 1, query_len)
        # indel overlaps shift the target-side end (OverlapBlock::toOverlap)
        sc2 = SeqCoord(0, ol - 1 - block.num_insertion + block.num_deletion,
                       target_len)
        if q_rev:
            sc1.flip()
        if t_rev:
            sc2.flip()
        o = Overlap((query_id, target_id),
                    Match((sc1, sc2), q_rev != t_rev, block.num_diff))
        # canonical-direction + containment duplicate filter
        if o.id[0] < o.id[1] or (o.match.is_containment() and q_rev):
            continue
        out.append(o)
    return out


def overlap_all(ix, records: list, min_overlap: int, lex_fwd, lex_rev,
                on_vertex=None, on_edge=None, irreducible: bool = False,
                error_rate: float = -1.0, max_indel: int = 0) -> dict:
    """Full overlap pass over (id, seq) records; calls back with VT/ED
    payloads in the reference's order (vertices as processed, edges after).
    irreducible=True emits only irreducible overlaps (the reference's
    default exact mode, --exact); error_rate >= 0 dispatches to the inexact
    FM-walk engine (StriDe/overlap.cpp:191-192), whose output is always
    exhaustive (:388-393)."""
    read_ids = [rid for rid, _ in records]
    read_lens = [len(s) for _, s in records]
    stats = {"substrings": 0, "edges": 0}
    edges = []
    for rid, seq in records:
        if error_rate >= 0:
            from .overlap_inexact import overlap_read_inexact_fmwalk

            blocks, is_sub = overlap_read_inexact_fmwalk(
                ix, seq, min_overlap, error_rate, max_indel)
            contains = []
        else:
            blocks, contains, is_sub = overlap_read_exact(
                ix, seq, min_overlap, irreducible)
        if on_vertex is not None:
            on_vertex(rid, seq, is_sub)
        if is_sub:
            stats["substrings"] += 1
            continue
        for b in blocks + contains:
            edges.extend(block_to_overlaps(
                b, rid, len(seq), lex_fwd, lex_rev, read_ids, read_lens))
    for o in edges:
        if on_edge is not None:
            on_edge(o)
    stats["edges"] = len(edges)
    return stats
