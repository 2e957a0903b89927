"""String-graph visitor passes used by `assemble` / `asmlong`.

Re-implementations of the reference visitors (StringGraph/SGVisitors.cpp;
per-class citations below).  Each visitor follows the reference protocol:
previsit(graph) -> visit(graph, vertex) per vertex -> postvisit(graph),
with GC_BLACK marking + sweep in postvisit.
"""
from __future__ import annotations

import numpy as np

from ..core import alphabet as ab
from .core import (ED_ANTISENSE, ED_SENSE, GC_BLACK, GC_GRAY, GC_WHITE,
                   StringGraph, Vertex)


class GraphStatsVisitor:
    """SGGraphStatsVisitor (SGVisitors.cpp:545-)."""

    def previsit(self, g):
        self.num_terminal = 0
        self.num_island = 0
        self.num_monobranch = 0
        self.num_dibranch = 0
        self.num_simple = 0
        self.num_edges = 0
        self.num_vertex = 0
        self.sum_len = 0

    def visit(self, g, v: Vertex):
        s_count = v.count_edges(ED_SENSE)
        as_count = v.count_edges(ED_ANTISENSE)
        if s_count == 0 and as_count == 0:
            self.num_island += 1
        elif s_count == 0 or as_count == 0:
            self.num_terminal += 1
        if s_count > 1 and as_count > 1:
            self.num_dibranch += 1
        elif s_count > 1 or as_count > 1:
            self.num_monobranch += 1
        if s_count == 1 or as_count == 1:
            self.num_simple += 1
        self.num_edges += v.count_edges()
        self.num_vertex += 1
        self.sum_len += len(v.seq)
        return False

    def postvisit(self, g):
        print(f"[SGStats] Vertices: {self.num_vertex} Edges: {self.num_edges} "
              f"Islands: {self.num_island} Tips: {self.num_terminal} "
              f"Monobranch: {self.num_monobranch} Dibranch: {self.num_dibranch} "
              f"Simple: {self.num_simple} SumLen: {self.sum_len}")


class ContainRemoveVisitor:
    """SGContainRemoveVisitor (SGVisitors.cpp:190-240): drop contained
    vertices and their edges.  The exhaustive-graph path needs no edge
    remodelling (the reference remodels only for irreducible graphs)."""

    def previsit(self, g: StringGraph):
        g.has_containment = False

    def visit(self, g, v: Vertex):
        if not v.contained:
            return False
        for e in list(v.edges):
            if e.twin in e.end.edges:
                e.end.remove_edge(e.twin)
        v.edges.clear()
        v.color = GC_BLACK
        return False

    def postvisit(self, g: StringGraph):
        g.sweep_vertices(GC_BLACK)


class TransitiveReductionVisitor:
    """SGTransitiveReductionVisitor (SGVisitors.cpp:64-160): Myers'
    transitive reduction with FUZZ=10."""

    FUZZ = 10

    def previsit(self, g):
        self.marked = 0

    def visit(self, g, v: Vertex):
        for dir in (ED_SENSE, ED_ANTISENSE):
            edges = v.get_edges(dir, sort_by_seqlen=True)
            if not edges:
                continue
            for e in edges:
                e.end.color = GC_GRAY
            longest_len = edges[-1].seq_len() + self.FUZZ
            # stage 1
            for vw in edges:
                w = vw.end
                if w.color != GC_GRAY:
                    continue
                for wx in w.get_edges(vw.transitive_dir(), sort_by_seqlen=True):
                    if vw.seq_len() + wx.seq_len() > longest_len:
                        break
                    if wx.end.color == GC_GRAY:
                        wx.end.color = GC_BLACK
            # stage 2
            for vw in edges:
                w = vw.end
                for j, wx in enumerate(w.get_edges(vw.transitive_dir(),
                                                   sort_by_seqlen=True)):
                    if wx.seq_len() < self.FUZZ or j == 0:
                        if wx.end.color == GC_GRAY:
                            wx.end.color = GC_BLACK
                    else:
                        break
            for e in edges:
                if e.end.color == GC_BLACK:
                    if e.color != GC_BLACK or e.twin.color != GC_BLACK:
                        e.color = GC_BLACK
                        e.twin.color = GC_BLACK
                        self.marked += 2
                e.end.color = GC_WHITE
        return False

    def postvisit(self, g: StringGraph):
        g.sweep_edges(GC_BLACK)


class TrimVisitor:
    """SGTrimVisitor (SGVisitors.cpp:260-320): remove short islands and
    dead-end tips."""

    def __init__(self, min_length: int):
        self.min_length = min_length

    def previsit(self, g):
        self.num_island = 0
        self.num_terminal = 0

    def visit(self, g, v: Vertex):
        if v.count_edges() == 0:
            if len(v.seq) < self.min_length:
                v.color = GC_BLACK
                self.num_island += 1
            return False
        for dir in (ED_SENSE, ED_ANTISENSE):
            if v.count_edges(dir) == 0 and len(v.seq) < self.min_length:
                v.color = GC_BLACK
                self.num_terminal += 1
                return True
        return False

    def postvisit(self, g: StringGraph):
        g.sweep_vertices(GC_BLACK)


class IllegalKmerEdgeVisitor:
    """SGRemoveIllegalKmerEdgeVisitor (SGVisitors.cpp:678-740): remove
    matchLen == k-1 edges whose flanking k-mers are strong on both sides
    (kmerized repeat joins)."""

    def __init__(self, host_ix, kmer_length: int, threshold: float,
                 credible_overlap: int):
        self.ix = host_ix
        self.k = kmer_length
        self.threshold = threshold
        self.credible_overlap = credible_overlap

    def _count_single(self, s: str) -> int:
        lo, hi = self.ix.bwt.find_interval(ab.encode(s))
        return int(max(hi - lo + 1, 0))

    def _strong(self, kmer: str) -> bool:
        return (self._count_single(kmer) >= self.threshold
                and self._count_single(ab.revcomp_str(kmer)) >= self.threshold)

    def _edge_kmer(self, seq: str, dir: int, match_len: int) -> str:
        if dir == ED_SENSE:
            return seq[len(seq) - match_len - 1 : len(seq) - match_len - 1 + self.k]
        return seq[match_len + 1 - self.k : match_len + 1]

    def visit(self, g, v: Vertex):
        changed = False
        for e in v.edges:
            match_len = e.match_length()
            if match_len != self.k - 1:
                continue
            kmer = self._edge_kmer(v.seq, e.dir, match_len)
            if len(kmer) < self.k:
                continue
            if not self._strong(kmer):
                continue  # weak kmer: edge explained by kmerization, keep
            other = self._edge_kmer(e.end.seq, e.twin.dir, match_len)
            if len(other) == self.k and self._strong(other):
                e.color = GC_BLACK
                e.twin.color = GC_BLACK
                changed = True
        return changed

    def postvisit(self, g: StringGraph):
        g.sweep_edges(GC_BLACK)


class BothShortEdgesRemoveVisitor:
    """SGBothShortEdgesRemoveVisitor (SGVisitors.cpp:755-830): remove small
    vertices whose best overlap on BOTH sides is short (chimera signature),
    optionally rescued by high average k-mer frequency."""

    def __init__(self, vertex_length: int, overlap_length: int, host_ix=None,
                 kmer_length: int = 0, threshold: float = 0):
        self.vertex_length = vertex_length
        self.overlap_length = overlap_length
        self.ix = host_ix
        self.k = kmer_length
        self.threshold = threshold

    def visit(self, g, v: Vertex):
        if (len(v.seq) > self.vertex_length or len(v.seq) < max(self.k, 1)
                or v.count_edges(ED_ANTISENSE) == 0
                or v.count_edges(ED_SENSE) == 0):
            return False
        maxes = {}
        for dir in (ED_SENSE, ED_ANTISENSE):
            maxes[dir] = max(e.match_length() for e in v.get_edges(dir))
        if not (maxes[ED_SENSE] <= self.overlap_length
                and maxes[ED_ANTISENSE] <= self.overlap_length):
            return False
        avg = -1.0
        if self.ix is not None and self.k > 0 and self.threshold > 0:
            enc = ab.encode(v.seq)
            if len(enc) >= self.k:
                win = np.lib.stride_tricks.sliding_window_view(enc, self.k)
                lo1, hi1 = self.ix.bwt.find_interval(win)
                rc = ab.complement(win)[:, ::-1]
                lo2, hi2 = self.ix.bwt.find_interval(rc)
                counts = (np.maximum(hi1 - lo1 + 1, 0)
                          + np.maximum(hi2 - lo2 + 1, 0))
                avg = float(counts.sum()) / len(counts)
        if avg < 0 or avg <= self.threshold:
            v.color = GC_BLACK
            return True
        return False

    def postvisit(self, g: StringGraph):
        g.sweep_vertices(GC_BLACK)


class RemoveByOverlapLenDiffVisitor:
    """SGRemoveByOverlapLenDiffVisitor (SGVisitors.cpp:1290-1360): from
    large vertices, cut edges whose overlap is much shorter than the best
    edge (chimeric/repeat edges); island-protect restores if all edges of a
    direction would vanish."""

    def __init__(self, min_vertex_size: int, min_overlap: int,
                 max_overlap_diff: int, island_protect: bool = True):
        self.min_vertex_size = min_vertex_size
        self.min_overlap = min_overlap
        self.max_overlap_diff = max_overlap_diff
        self.island_protect = island_protect

    def visit(self, g, v: Vertex):
        changed = False
        if len(v.seq) < self.min_vertex_size:
            return False
        for dir in (ED_SENSE, ED_ANTISENSE):
            edges = sorted(v.get_edges(dir), key=lambda e: e.match_length())
            if len(edges) <= 1:
                continue
            maxlen = edges[-1].match_length()
            if self.min_overlap > 0 and maxlen > self.min_overlap:
                for e in edges:
                    if e.match_length() < self.min_overlap:
                        e.color = GC_BLACK
                        e.twin.color = GC_BLACK
                        changed = True
            if (self.max_overlap_diff > 0
                    and maxlen - edges[0].match_length() >= self.max_overlap_diff):
                for e in edges[:-1]:
                    if maxlen - e.match_length() >= self.max_overlap_diff:
                        e.color = GC_BLACK
                        e.twin.color = GC_BLACK
                        changed = True
            if self.island_protect:
                if all(e.color != GC_WHITE for e in edges):
                    for e in edges:
                        e.color = GC_WHITE
                        e.twin.color = GC_WHITE
                    changed = False
        return changed

    def postvisit(self, g: StringGraph):
        g.sweep_edges(GC_BLACK)


class SmoothingVisitor:
    """Bubble smoothing, simplified from SGSmoothingVisitor
    (SGVisitors.cpp:390-470): when a vertex branches into exactly two
    single-edge paths that reconverge, keep the higher-coverage branch if
    the branch lengths diverge by at most max_indel.  (The reference
    additionally gap-validates variant walks against the BWT; this
    length+coverage criterion covers the assemble pipeline's use.)"""

    def __init__(self, max_indel: int = 9):
        self.max_indel = max_indel
        self.removed = 0

    def visit(self, g, v: Vertex):
        changed = False
        for dir in (ED_SENSE, ED_ANTISENSE):
            edges = v.get_edges(dir)
            if len(edges) != 2:
                continue
            a, b = edges
            ends = []
            for e in (a, b):
                w = e.end
                if w.count_edges(e.twin.dir) != 1 or w.count_edges(1 - e.twin.dir) != 1:
                    ends.append(None)
                    continue
                nxt = w.get_edges(1 - e.twin.dir)[0]
                ends.append((w, nxt.end, nxt))
            if ends[0] is None or ends[1] is None:
                continue
            if ends[0][1] is not ends[1][1]:
                continue  # paths do not reconverge
            la = len(ends[0][0].seq)
            lb = len(ends[1][0].seq)
            if abs(la - lb) > self.max_indel:
                continue
            drop = ends[0][0] if ends[0][0].coverage <= ends[1][0].coverage else ends[1][0]
            g.remove_vertex(drop)
            self.removed += 1
            changed = True
        return changed


class FastaVisitor:
    """SGFastaVisitor: contig emission."""

    def __init__(self, fh):
        self.fh = fh
        self.n = 0

    def visit(self, g, v: Vertex):
        self.fh.write(f">{v.id} {len(v.seq)} {v.coverage}\n{v.seq}\n")
        self.n += 1
        return False


def sample_kmer_counts(fm, kmer_size: int, sample_size: int, seed: int = 1):
    """BWTAlgorithms::sampleKmerCounts (BWTAlgorithms.cpp:527-539): sample
    `sample_size` reads, take each read's trailing kmer_size-suffix (in the
    index's orientation, extractString semantics :454-470) and histogram its
    both-strand occurrence count.  The reference draws reads with rand();
    we use a seeded generator (deterministic, same distribution).
    """
    import numpy as np

    from ..core.kmercheck import KmerDistribution

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, fm.num_strings, size=sample_size).astype(np.int64)
    words = np.zeros((sample_size, kmer_size), np.int8)
    alive = np.ones(sample_size, bool)
    # walk LF backwards from each read's $-row: emits last char first
    for step in range(kmer_size):
        syms = fm.symbols[rows].astype(np.int64)
        hit_end = alive & (syms == 0)
        alive &= ~hit_end
        if not alive.any():
            break
        words[alive, kmer_size - 1 - step] = syms[alive]
        nrows = fm.pc(syms) + fm.occ(syms, rows - 1)
        rows = np.where(alive, nrows, rows)
    kd = KmerDistribution()
    full = words[:, 0] != 0
    if full.any():
        w = words[full]
        lo, hi = fm.find_interval(w)
        fwd = np.maximum(hi - lo + 1, 0)
        # per-row reverse complement (ab.reverse_complement is 1-D only)
        lo, hi = fm.find_interval(ab.complement(w)[:, ::-1])
        rvc = np.maximum(hi - lo + 1, 0)
        for c in (fwd + rvc).tolist():
            kd.add(int(c))
    for i in np.flatnonzero(~full):
        # short read: count its truncated suffix (reference counts it too)
        w = words[i][words[i] != 0]
        if len(w) == 0:
            kd.add(0)
            continue
        lo, hi = fm.find_interval(w)
        n = max(int(hi - lo + 1), 0)
        lo, hi = fm.find_interval(ab.reverse_complement(w))
        kd.add(n + max(int(hi - lo + 1), 0))
    return kd


def _count_single_strand(fm, word) -> int:
    """BWTAlgorithms::countSequenceOccurrencesSingleStrand."""
    lo, hi = fm.find_interval(word)
    return max(int(hi - lo + 1), 0)


class _NameSet:
    """NameSet (SGVisitors.h:25-52): read IDs whose reads contain a seed
    k-mer, resolved through the sampled SA; interval capped at max_ids rows
    (SGVisitors.cpp:1773-1792)."""

    def __init__(self, fm, ssa, max_ids: int = 200):
        self.fm = fm
        self.ssa = ssa
        self.max_ids = max_ids
        self.ids: set[int] = set()

    def _rows(self, word):
        lo, hi = self.fm.find_interval(word)
        lo, hi = int(lo), int(hi)
        if hi < lo:
            return None
        hi = min(hi, lo + self.max_ids - 1)
        import numpy as np

        return np.arange(lo, hi + 1, dtype=np.int64)

    def add_read_ids(self, word) -> list[int]:
        rows = self._rows(word)
        if rows is None:
            return []
        ids, _ = self.ssa.calc_sa(rows)
        new = [int(i) for i in ids]
        self.ids.update(new)
        return new

    def another_ids(self) -> list[int]:
        """getAnotherReadIDs: mate of read i is i^1 (PE interleaved)."""
        return [i ^ 1 for i in self.ids]

    def __contains__(self, idx: int) -> bool:
        return idx in self.ids


# ReadOnContig (Util/Util.h:158-165)
ROC_ANTISENSE_FWD, ROC_ANTISENSE_RVC, ROC_SENSE_FWD, ROC_SENSE_RVC = range(4)


class FastaErosionVisitor:
    """SGFastaErosionVisitor (SGVisitors.cpp:606-668): trim island/tip ends
    back to the first k-mer supported on both strands of the read index."""

    def __init__(self, fm, kmer_length: int, threshold: int,
                 min_island: int = 500, erosion: int = 1):
        self.fm = fm
        self.k = kmer_length
        self.threshold = threshold
        self.min_island = min_island
        self.erosion = erosion

    def _supported(self, kmer_enc) -> bool:
        same = _count_single_strand(self.fm, kmer_enc)
        revc = _count_single_strand(self.fm, ab.reverse_complement(kmer_enc))
        return ((same >= self.threshold and revc >= self.erosion)
                or (same >= self.erosion and revc >= self.threshold))

    def visit(self, g, v: Vertex):
        seq_len = len(v.seq)
        if seq_len < self.k:
            return False
        enc = ab.encode(v.seq)
        start, end = 0, seq_len
        if v.count_edges(ED_ANTISENSE) == 0:
            for i in range(seq_len - self.k + 1):
                if self._supported(enc[i : i + self.k]):
                    start = i
                    break
        if v.count_edges(ED_SENSE) == 0:
            for i in range(seq_len - self.k, -1, -1):
                if self._supported(enc[i : i + self.k]):
                    end = i + self.k
                    break
        length = end - start
        if length >= self.min_island and (v.count_edges(ED_ANTISENSE) == 0
                                          or v.count_edges(ED_SENSE) == 0):
            v.seq = v.seq[start : start + length]
            for e in v.get_edges(ED_SENSE):
                e.update_seq_len(length)
                e.offset_match(length - seq_len)  # antisense may be trimmed
            for e in v.get_edges(ED_ANTISENSE):
                e.update_seq_len(length)
        return False


class IslandCollectVisitor:
    """SGIslandCollectVisitor (SGVisitors.cpp:1371-1441): for every
    island/tip end, map non-repeat k-mer seeds (one per 20bp up to the
    insert size) to read IDs through the sampled SA; records land in
    `tslv` (read id -> [(vertex id, ReadOnContig)]) and per-vertex
    direction lists for the join visitor."""

    def __init__(self, indices, ssa, insert_size: int, kmer_size: int = 51,
                 island_size: int = 500):
        self.ix = indices            # HostIndexSet
        self.ssa = ssa
        self.insert_size = insert_size
        self.k = kmer_size
        self.min_island = island_size
        self.tslv: dict[int, list] = {}
        self.vertex_read_ids: dict[str, list[list[int]]] = {}

    def previsit(self, g):
        self.island_count = 0
        kd = sample_kmer_counts(self.ix.rbwt, self.k, 100000)
        self.repeat_cutoff = kd.get_cutoff_for_proportion(0.75)
        kd.compute_attributes()
        print(f"[IslandCollect] median kmer freq: {kd.q2} repeat cutoff: "
              f"{self.repeat_cutoff} min island/tip size: {self.min_island} "
              f"kmer: {self.k} insert: {self.insert_size}")

    def _add(self, word, vertex, roc, bucket: _NameSet):
        for rid in bucket.add_read_ids(word):
            self.tslv.setdefault(rid, []).append((vertex.id, roc))

    def visit(self, g, v: Vertex):
        if not ((v.count_edges(ED_SENSE) == 0
                 or v.count_edges(ED_ANTISENSE) == 0)
                and len(v.seq) >= self.min_island):
            return False
        self.island_count += 1
        enc = ab.encode(v.seq)
        buckets = [_NameSet(self.ix.bwt, self.ssa) for _ in range(4)]
        for i in range(0, self.insert_size, 20):
            if i + self.k > len(v.seq):
                break
            if v.count_edges(ED_SENSE) == 0:
                seed = enc[len(v.seq) - i - self.k : len(v.seq) - i]
                if self.ix.bwt.count_occurrences_both_strands(seed) < self.repeat_cutoff:
                    self._add(seed, v, ROC_SENSE_FWD, buckets[2])
                    self._add(ab.reverse_complement(seed), v, ROC_SENSE_RVC,
                              buckets[3])
            if v.count_edges(ED_ANTISENSE) == 0:
                seed = enc[i : i + self.k]
                if self.ix.bwt.count_occurrences_both_strands(seed) < self.repeat_cutoff:
                    self._add(seed, v, ROC_ANTISENSE_FWD, buckets[0])
                    self._add(ab.reverse_complement(seed), v,
                              ROC_ANTISENSE_RVC, buckets[1])
        self.vertex_read_ids[v.id] = [sorted(b.ids) for b in buckets]
        return True

    def postvisit(self, g):
        print(f"IslandCollect: Collect {self.island_count} islands/tips "
              f"for FM-index walk")


class JoinIslandVisitor:
    """SGJoinIslandVisitor (SGVisitors.cpp:1443-1740): join islands/tips
    that share paired-end read support with a two-read FM-index walk
    (SAIntervalTree in kmer mode), then create the connecting edges."""

    def __init__(self, search_depth: int, search_leaves: int, kmer: int,
                 island_size: int, collect: IslandCollectVisitor,
                 indices, min_pe_count: int = 5):
        self.depth = search_depth
        self.leaves = search_leaves
        self.k = kmer
        self.min_island = island_size
        self.collect = collect
        self.ix = indices
        self.min_pe = min_pe_count
        self.iterations = 2   # m_numOfIterations (SGVisitors.h:445)

    def previsit(self, g):
        self.island_count = 0
        print(f"[JoinIsland] min PE support: {self.min_pe} kmer: {self.k}")

    # -- helpers ---------------------------------------------------------
    def _neighbors_with_pe(self, v: Vertex, island_dir: int) -> dict:
        """findNeighborWithPESupport (SGVisitors.cpp:1466-1499)."""
        out: dict[str, list[int]] = {}
        ids = self.collect.vertex_read_ids.get(v.id, [[], [], [], []])
        for rid in ids[island_dir]:
            mate = rid ^ 1
            for wid, roc in self.collect.tslv.get(mate, ()):
                counts = out.setdefault(wid, [0, 0, 0, 0])
                counts[roc] += 1
        return out

    def _merge_walk(self, start_full: str, target: str):
        """The 2-iteration SAIntervalTree kmer-mode walk ladder."""
        from ..core.pe_merge import SAIntervalTree

        for i in range(self.iterations):
            start = start_full[: len(start_full) - i * self.k]
            if len(start) < self.k:
                break
            tree = SAIntervalTree(
                self.ix, start, self.k, 100, len(start) + self.depth,
                self.leaves, second_read=target, sa_threshold=1,
                kmer_mode=True,
            )
            code, merged = tree.merge_two_reads()
            if code > 0 and merged:
                return merged
        return None

    def _update_extended(self, v: Vertex, new_str: str, dir: int) -> None:
        """updateExtendedVertex (SGVisitors.cpp:1501-1511)."""
        v.seq = new_str
        for e in v.get_edges(dir):
            e.update_seq_len(len(new_str))

    def visit(self, g, v: Vertex):
        from .core import EC_REVERSE, EC_SAME, Edge, SeqCoord

        if not ((v.count_edges(ED_SENSE) == 0
                 or v.count_edges(ED_ANTISENSE) == 0)
                and len(v.seq) >= self.min_island):
            return False

        k = self.k
        for island_dir in range(4):
            if v.count_edges(ED_ANTISENSE) > 0 and island_dir in (0, 1):
                continue
            if v.count_edges(ED_SENSE) > 0 and island_dir in (2, 3):
                continue
            for wid, cnt in self._neighbors_with_pe(v, island_dir).items():
                w = g.get_vertex(wid)
                if w is None or w is v:
                    continue
                pre_f, pre_r, suf_f, suf_r = cnt
                # impossible-case skips (SGVisitors.cpp:1546-1549; the
                # SenseRvc comparison is inverted in the reference — kept)
                if island_dir == 0 and pre_f <= self.min_pe and suf_r <= self.min_pe:
                    continue
                if island_dir == 1 and pre_r <= self.min_pe and suf_f <= self.min_pe:
                    continue
                if island_dir == 2 and suf_f <= self.min_pe and pre_r <= self.min_pe:
                    continue
                if island_dir == 3 and suf_r <= self.min_pe and pre_f > self.min_pe:
                    continue
                v_str, w_str = v.seq, w.seq

                # case 1: prefix-prefix (EC_REVERSE)
                if ((island_dir == 0 and pre_f > self.min_pe)
                        or (island_dir == 1 and pre_r > self.min_pe)) \
                        and v.count_edges(ED_ANTISENSE) == 0 \
                        and w.count_edges(ED_ANTISENSE) == 0:
                    merged = self._merge_walk(ab.revcomp_str(w_str), v_str)
                    if merged:
                        w_new = merged[: len(merged) - len(v_str) + k]
                        w.seq = ab.revcomp_str(w_new)
                        for e in w.get_edges(ED_SENSE):
                            e.update_seq_len(len(w_new))
                            e.offset_match(len(w_new) - len(w_str))
                        cv = SeqCoord(0, k - 1, len(v_str))
                        cw = SeqCoord(0, k - 1, len(w_new))
                        self._link(g, v, w, ED_ANTISENSE, ED_ANTISENSE,
                                   EC_REVERSE, cv, cw)

                # case 4: V prefix joins W suffix (EC_SAME)
                elif ((island_dir == 0 and suf_r > self.min_pe)
                        or (island_dir == 1 and suf_f > self.min_pe)) \
                        and v.count_edges(ED_ANTISENSE) == 0 \
                        and w.count_edges(ED_SENSE) == 0:
                    merged = self._merge_walk(w_str, v_str)
                    if merged:
                        w_new = merged[: len(merged) - len(v_str) + k]
                        self._update_extended(w, w_new, ED_ANTISENSE)
                        cv = SeqCoord(0, k - 1, len(v_str))
                        cw = SeqCoord(len(w_new) - k, len(w_new) - 1, len(w_new))
                        self._link(g, v, w, ED_ANTISENSE, ED_SENSE,
                                   EC_SAME, cv, cw)

                # case 5: suffix-suffix (EC_REVERSE)
                elif ((island_dir == 2 and suf_f > self.min_pe)
                        or (island_dir == 3 and suf_r > self.min_pe)) \
                        and v.count_edges(ED_SENSE) == 0 \
                        and w.count_edges(ED_SENSE) == 0:
                    merged = self._merge_walk(v_str, ab.revcomp_str(w_str))
                    if merged:
                        v_new = merged[: len(merged) - len(w_str) + k]
                        self._update_extended(v, v_new, ED_ANTISENSE)
                        cv = SeqCoord(len(v_new) - k, len(v_new) - 1, len(v_new))
                        cw = SeqCoord(len(w_str) - k, len(w_str) - 1, len(w_str))
                        self._link(g, v, w, ED_SENSE, ED_SENSE,
                                   EC_REVERSE, cv, cw)

                # case 8: V suffix joins W prefix (EC_SAME)
                elif ((island_dir == 2 and pre_r > self.min_pe)
                        or (island_dir == 3 and pre_f > self.min_pe)) \
                        and v.count_edges(ED_SENSE) == 0 \
                        and w.count_edges(ED_ANTISENSE) == 0:
                    merged = self._merge_walk(v_str, w_str)
                    if merged:
                        v_new = merged[: len(merged) - len(w_str) + k]
                        self._update_extended(v, v_new, ED_ANTISENSE)
                        cv = SeqCoord(len(v_new) - k, len(v_new) - 1, len(v_new))
                        cw = SeqCoord(0, k - 1, len(w_str))
                        self._link(g, v, w, ED_SENSE, ED_ANTISENSE,
                                   EC_SAME, cv, cw)
        return True

    def _link(self, g, v, w, dir_v, dir_w, comp, coord_v, coord_w) -> None:
        from .core import Edge

        e_vw = Edge(v, w, dir_v, comp, coord_v)
        e_wv = Edge(w, v, dir_w, comp, coord_w)
        e_vw.twin, e_wv.twin = e_wv, e_vw
        v.edges.append(e_vw)
        w.edges.append(e_wv)
        self.island_count += 1

    def postvisit(self, g):
        print(f"JoinIsland: joined {self.island_count} islands/tips")
        g.simplify()


class LowOverlapRatioEdgeSweepVisitor:
    """SGLowOverlapRatioEdgeSweepVisitor (SGVisitors.cpp:830-900): on small
    vertices, remove edges whose match length is a small fraction of the
    shorter flanking origin read length."""

    def __init__(self, min_vertex_size: int, overlap_ratio: float,
                 match_length: int):
        self.min_vertex_size = min_vertex_size
        self.ratio = overlap_ratio
        self.match_length = match_length

    def previsit(self, g):
        for v in g.vertices.values():
            for e in v.edges:
                e.color = GC_WHITE

    def visit(self, g, v: Vertex):
        if len(v.seq) >= self.min_vertex_size:
            return False
        changed = False
        for dir in (ED_SENSE, ED_ANTISENSE):
            origin = v.origin_length[dir]
            for e in v.get_edges(dir):
                match_len = e.match_length()
                if self.match_length != 0 and match_len > self.match_length:
                    continue
                other_origin = e.end.origin_length[e.twin.dir]
                min_len = min(origin, other_origin)
                if min_len and match_len / min_len < self.ratio:
                    e.color = GC_BLACK
                    e.twin.color = GC_BLACK
                    changed = True
        return changed

    def postvisit(self, g):
        n = g.sweep_edges(GC_BLACK)
        print(f"LowOverlapRatioSweep: removed {n // 2} low-ratio edges")


class RemoveEdgeByPEVisitor:
    """SGRemoveEdgeByPEVisitor (SGVisitors.cpp:1115-1283): remove edges
    whose graph walks lack paired-end read support at the insert size."""

    def __init__(self, indices, ssa, insert_size: int, kmer_size: int = 51,
                 min_pe_count: int = 1):
        self.ix = indices
        self.ssa = ssa
        self.insert_size = insert_size
        self.k = kmer_size
        self.min_pe = min_pe_count

    def previsit(self, g):
        self.edge_count = 0
        for v in g.vertices.values():
            v.edges.sort(key=lambda e: e.match_length())
            for e in v.edges:
                e.color = GC_WHITE

    def visit(self, g, v: Vertex):
        from . import search as sgsearch

        changed = False
        for dir in (ED_SENSE, ED_ANTISENSE):
            edges = v.get_edges(dir)
            if not edges:
                continue
            walks = sgsearch.get_tree_walks(
                v, dir, int(self.insert_size * 1.5), 128)
            insert_var = self.k // 2 + 1
            goals = [None] * len(walks)
            for e in edges:
                if e.match_length() >= self.insert_size * 0.8:
                    continue
                seq = v.seq if dir == ED_SENSE else ab.revcomp_str(v.seq)
                enc = ab.encode(seq)
                pv = _NameSet(self.ix.bwt, self.ssa)
                boundary = len(v.seq) - e.match_length() - 1
                for pos in (boundary, boundary - self.k // 2,
                            boundary - self.k):
                    p = max(pos, 0)
                    word = enc[p : p + self.k]
                    if len(word) == self.k:
                        pv.add_read_ids(word)
                        pv.add_read_ids(ab.reverse_complement(word))
                boundary = max(boundary - self.k // 2, 0)
                mates = pv.another_ids()
                pe_count = 0
                for i, wk in enumerate(walks):
                    if wk.first_edge() is not e:
                        continue
                    if goals[i] is None:
                        goals[i] = _NameSet(self.ix.bwt, self.ssa, 600)
                        ws = wk.get_string()
                        if dir != ED_SENSE:
                            ws = ab.revcomp_str(ws)
                        wenc = ab.encode(ws)
                        for off in (-insert_var, 0, insert_var):
                            tpos = boundary + self.insert_size + off
                            if len(ws) >= tpos and tpos >= self.k:
                                word = wenc[tpos - self.k : tpos]
                                goals[i].add_read_ids(word)
                                goals[i].add_read_ids(
                                    ab.reverse_complement(word))
                    for m in mates:
                        if m in goals[i]:
                            pe_count += 1
                        if pe_count >= self.min_pe:
                            break
                    if pe_count >= self.min_pe:
                        break
                if pe_count < self.min_pe and e.color == GC_WHITE:
                    e.color = GC_BLACK
                    e.twin.color = GC_BLACK
                    self.edge_count += 1
                    changed = True
        return changed

    def postvisit(self, g):
        n = g.sweep_edges(GC_BLACK)
        print(f"RemoveEdgeByPE: removed {n // 2} edges without PE support "
              f"at insert size {self.insert_size}")


def graph_trim_and_smooth(g: StringGraph, trim_length: int, host_ix=None,
                          max_indel: int = 9) -> None:
    """graphTrimAndSmooth (StriDe/assemble.cpp:461-490)."""
    g.simplify()
    trim = TrimVisitor(trim_length)
    smooth = SmoothingVisitor(max_indel)
    if g.visit(trim):
        g.simplify()
    if g.visit(smooth):
        g.simplify()
        if g.visit(trim):
            g.simplify()


def contig_stats(g: StringGraph) -> dict:
    lens = sorted((len(v.seq) for v in g.vertices.values()), reverse=True)
    if not lens:
        return {"contigs": 0, "total": 0, "n50": 0, "max": 0}
    total = sum(lens)
    acc = 0
    n50 = 0
    for ln in lens:
        acc += ln
        if acc >= total / 2:
            n50 = ln
            break
    return {"contigs": len(lens), "total": total, "n50": n50, "max": lens[0]}
