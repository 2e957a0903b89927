"""FM-merge: collapse unambiguously-connected reads into unitigs
(`stride merge`).

Re-implementation of FMMergeProcess (Algorithm/FMMergeProcess.{h,cpp}:30-290
behind StriDe/fm-merge.cpp:83): starting from an unused read, grow a local
graph by following reads that are the UNIQUE irreducible extension in a
direction; a candidate joins when its own overlap blocks have exactly one
edge back in the merge direction.  Used reads are claimed in a BitVector
over forward lexicographic ranks; the serial claim order makes single-
process output deterministic.

Where the reference reconstructs candidate sequences from the FM extension
history (OverlapBlock::getFullString), we resolve the read id through the
lexicographic index and take the sequence from the read table — identical
strings, one array lookup.
"""
from __future__ import annotations

import numpy as np

from ..core import alphabet as ab
from . import overlap as ovl
from .core import ED_ANTISENSE, ED_SENSE, GC_RED, StringGraph


def _edge_dir(block) -> int:
    """OverlapBlock::getEdgeDir: queryRev -> ANTISENSE."""
    return ED_ANTISENSE if block.flags[0] else ED_SENSE


class FMMerger:
    def __init__(self, ix, records: list, lex_fwd, lex_rev, min_overlap: int):
        self.ix = ix
        self.records = records
        self.ids = [rid for rid, _ in records]
        self.seqs = [s for _, s in records]
        self.lex_fwd = np.asarray(lex_fwd, np.int64)
        self.lex_rev = np.asarray(lex_rev, np.int64)
        self.min_overlap = min_overlap
        # read index -> forward lexicographic rank
        self.fwd_rank = np.empty(len(self.lex_fwd), np.int64)
        self.fwd_rank[self.lex_fwd] = np.arange(len(self.lex_fwd))
        self.marked = np.zeros(len(self.lex_fwd), bool)
        self.id_to_idx = {rid: i for i, rid in enumerate(self.ids)}

    # ------------------------------------------------------------------
    def _blocks(self, seq: str):
        blocks, _, _ = ovl.overlap_read_exact(self.ix, seq, self.min_overlap,
                                              irreducible=True)
        return [b for b in blocks if b.overlap_len != len(seq)]

    def _block_reads(self, block) -> list[int]:
        lex = self.lex_rev if block.flags[1] else self.lex_fwd
        out = []
        for j in range(block.lo, block.hi + 1):
            rid = int(lex[j])
            out.append(rid)
        return out

    def _add_candidates(self, g: StringGraph, x_id: str, x_len: int,
                        blocks, edge_to_x, queue) -> None:
        """addCandidates (FMMergeProcess.cpp:228-288): enqueue unique-
        per-direction extensions."""
        n_dir = {ED_SENSE: 0, ED_ANTISENSE: 0}
        for b in blocks:
            n_dir[_edge_dir(b)] += 1
        for b in blocks:
            d = _edge_dir(b)
            if n_dir[d] != 1:
                continue
            if edge_to_x is not None and edge_to_x.twin.dir == d:
                continue
            for ridx in self._block_reads(b):
                vid = self.ids[ridx]
                if vid == x_id:
                    continue
                from .core import Match, Overlap, SeqCoord
                q_rev, t_rev, _ = b.flags
                ol = b.overlap_len
                sc1 = SeqCoord(x_len - ol, x_len - 1, x_len)
                sc2 = SeqCoord(0, ol - 1, len(self.seqs[ridx]))
                if q_rev:
                    sc1.flip()
                if t_rev:
                    sc2.flip()
                ovr = Overlap((x_id, vid), Match((sc1, sc2), q_rev != t_rev, 0))
                if g.get_vertex(vid) is None:
                    g.add_vertex(vid, self.seqs[ridx])
                # skip if an identical edge already exists
                xv = g.get_vertex(x_id)
                dup = any(e.end.id == vid and e.dir == d for e in xv.edges)
                if dup:
                    continue
                e = g.add_edges_from_overlap(ovr)
                if e is not None:
                    queue.append((vid, e, ridx))

    # ------------------------------------------------------------------
    def merge_read(self, idx: int) -> list[str] | None:
        """FMMergeProcess::process for one read; returns merged sequences
        or None when the read was already claimed."""
        rid, seq = self.records[idx]
        root_rank = int(self.fwd_rank[idx])
        if self.marked[root_rank]:
            return None
        g = StringGraph()
        g.add_vertex(rid, seq)
        used = [idx]
        queue: list = []
        self._add_candidates(g, rid, len(seq), self._blocks(seq), None, queue)
        seen = {rid}
        while queue:
            vid, edge, ridx = queue.pop(0)
            if vid in seen:
                continue
            seen.add(vid)
            cseq = g.get_vertex(vid).seq
            cblocks = self._blocks(cseq)
            merge_dir = edge.twin.dir
            n_back = sum(1 for b in cblocks if _edge_dir(b) == merge_dir)
            if n_back == 1:
                self._add_candidates(g, vid, len(cseq), cblocks, edge, queue)
                used.append(ridx)
            else:
                g.get_vertex(vid).color = GC_RED
        g.sweep_vertices(GC_RED)
        g.simplify()
        # claim the used reads (serial: no CAS race)
        ranks = sorted(int(self.fwd_rank[i]) for i in set(used))
        if self.marked[ranks[0]]:
            return None
        for r in ranks:
            self.marked[r] = True
        return [v.seq for v in g.vertices.values()]

    def merge_all(self):
        n_merged = n_reads = 0
        for idx in range(len(self.records)):
            out = self.merge_read(idx)
            if out is None:
                continue
            for k, s in enumerate(out):
                yield (f"merged-{idx}-{k}", s)
                n_merged += 1
        return
