"""Bidirected string graph core.

Python re-design of the reference's Bigraph/StringGraph data model
(Bigraph/Bigraph.h:29-216, Bigraph/Vertex.cpp, Bigraph/Edge.cpp,
Util/SeqCoord.cpp, Util/Match.cpp).  Same semantics — twin edges, SeqCoord
match coordinates, label concatenation on merge — with python objects and
dict adjacency instead of intrusive pointers.

Colors follow the reference's GraphColor (WHITE default; visitors use
GRAY/BLACK/RED transiently).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core import alphabet as ab

# EdgeDir (Bigraph/GraphCommon.h)
ED_SENSE = 0      # overlap covers the right end (suffix) of the vertex
ED_ANTISENSE = 1  # overlap covers the left end (prefix)
# EdgeComp
EC_SAME = 0
EC_REVERSE = 1

GC_WHITE, GC_GRAY, GC_BLACK, GC_BLUE, GC_RED = range(5)


@dataclass
class SeqCoord:
    """[start, end] inclusive interval on a sequence of length seqlen
    (Util/SeqCoord.h)."""

    start: int
    end: int
    seqlen: int

    def length(self) -> int:
        return self.end - self.start + 1 if self.end >= self.start else 0

    def is_left_extreme(self) -> bool:
        return self.start == 0

    def is_right_extreme(self) -> bool:
        return self.end == self.seqlen - 1

    def is_extreme(self) -> bool:
        return self.is_left_extreme() or self.is_right_extreme()

    def is_full(self) -> bool:
        return self.is_left_extreme() and self.is_right_extreme()

    def is_empty(self) -> bool:
        return self.end < self.start

    def flip(self) -> None:
        s, e = self.start, self.end
        self.start = self.seqlen - 1 - e
        self.end = self.seqlen - 1 - s

    def flipped(self) -> "SeqCoord":
        c = SeqCoord(self.start, self.end, self.seqlen)
        c.flip()
        return c

    def complement(self) -> "SeqCoord":
        """The other part of the sequence (Util/SeqCoord.cpp complement)."""
        if self.is_full():
            return SeqCoord(0, -1, self.seqlen)
        if self.is_empty():
            return SeqCoord(0, self.seqlen - 1, self.seqlen)
        if self.is_left_extreme():
            return SeqCoord(max(self.start, self.end) + 1, self.seqlen - 1, self.seqlen)
        assert self.is_right_extreme(), self
        return SeqCoord(0, min(self.start, self.end) - 1, self.seqlen)

    def substring(self, s: str) -> str:
        return s[self.start : self.end + 1]

    def copy(self) -> "SeqCoord":
        return SeqCoord(self.start, self.end, self.seqlen)


@dataclass
class Match:
    """A pair of matched coordinates + orientation (Util/Match.h)."""

    coord: tuple
    is_rc: bool
    num_diff: int = 0

    def is_containment(self) -> bool:
        return self.coord[0].is_full() or self.coord[1].is_full()

    def _translation(self) -> tuple[int, int]:
        c1 = self.coord[1].flipped() if self.is_rc else self.coord[1]
        return (c1.start - self.coord[0].start, c1.end - self.coord[0].end)

    def _inverse_translation(self) -> tuple[int, int]:
        c0 = self.coord[0].flipped() if self.is_rc else self.coord[0]
        return (c0.start - self.coord[1].start, c0.end - self.coord[1].end)

    def translate(self, c: SeqCoord) -> SeqCoord:
        ts, te = self._translation()
        out = SeqCoord(c.start + ts, c.end + te, self.coord[1].seqlen)
        if self.is_rc:
            out.flip()
        return out

    def inverse_translate(self, c: SeqCoord) -> SeqCoord:
        ts, te = self._inverse_translation()
        out = SeqCoord(c.start + ts, c.end + te, self.coord[0].seqlen)
        if self.is_rc:
            out.flip()
        return out


@dataclass
class Overlap:
    """Named overlap between two reads (Util/Match.h:85)."""

    id: tuple
    match: Match

    def to_line(self) -> str:
        m = self.match
        c0, c1 = m.coord
        return (f"{self.id[0]} {self.id[1]} {c0.start} {c0.end} {c0.seqlen} "
                f"{c1.start} {c1.end} {c1.seqlen} {int(m.is_rc)} {m.num_diff}")

    @staticmethod
    def from_line(line: str) -> "Overlap":
        f = line.split()
        c0 = SeqCoord(int(f[2]), int(f[3]), int(f[4]))
        c1 = SeqCoord(int(f[5]), int(f[6]), int(f[7]))
        return Overlap((f[0], f[1]), Match((c0, c1), bool(int(f[8])), int(f[9])))


class Edge:
    """Half of a bidirected edge; `twin` is the other half
    (Bigraph/Edge.h)."""

    __slots__ = ("start", "end", "dir", "comp", "match_coord", "twin", "color")

    def __init__(self, start: "Vertex", end: "Vertex", dir: int, comp: int,
                 match_coord: SeqCoord):
        self.start = start
        self.end = end
        self.dir = dir
        self.comp = comp
        self.match_coord = match_coord
        self.twin: "Edge" = None
        self.color = GC_WHITE

    # --- reference accessors ---------------------------------------------
    def match_length(self) -> int:
        return self.match_coord.length()

    def seq_len(self) -> int:
        """Length of the unmatched part of the END vertex
        (Edge::getSeqLen, Bigraph/Edge.cpp:89)."""
        return self.twin.match_coord.complement().length()

    def twin_dir(self) -> int:
        return self.twin.dir

    def transitive_dir(self) -> int:
        """Direction to continue past `end` (== !twin.dir)."""
        return 1 - self.twin.dir

    def is_self(self) -> bool:
        return self.start is self.end

    def label(self) -> str:
        """Unmatched sequence of the end vertex, oriented to the start
        (Edge::getLabel)."""
        unmatched = self.twin.match_coord.complement()
        seq = unmatched.substring(self.end.seq)
        if self.comp == EC_REVERSE:
            seq = ab.revcomp_str(seq)
        return seq

    def get_match(self) -> Match:
        return Match((self.match_coord, self.twin.match_coord),
                     self.comp == EC_REVERSE)

    def update_seq_len(self, new_len: int) -> None:
        """Edge::updateSeqLen — the start vertex's sequence was resized."""
        self.match_coord.seqlen = new_len

    def offset_match(self, delta: int) -> None:
        """Edge::offsetMatch — the start vertex's prefix grew/shrank by
        delta; shift the match window."""
        self.match_coord.start += delta
        self.match_coord.end += delta

    def flip(self) -> None:
        self.comp = 1 - self.comp
        self.dir = 1 - self.dir

    def join(self, e: "Edge") -> None:
        """Move this edge's start across the merge edge `e` (Edge::join)."""
        m12 = e.get_match()
        self.match_coord = m12.inverse_translate(self.match_coord)
        if e.comp == EC_REVERSE:
            self.flip()
        # twin extends to e's twin's end (i.e. the merged vertex)
        t = self.twin
        if e.twin.comp == EC_REVERSE:
            t.comp = 1 - t.comp
        t.end = e.twin.end

    def __repr__(self):
        return (f"Edge({self.start.id}->{self.end.id} d{self.dir} c{self.comp} "
                f"{self.match_coord.start}-{self.match_coord.end}/{self.match_coord.seqlen})")


class Vertex:
    __slots__ = ("id", "seq", "edges", "color", "coverage", "contained",
                 "origin_length")

    def __init__(self, vid: str, seq: str):
        self.id = vid
        self.seq = seq
        self.edges: list[Edge] = []
        self.color = GC_WHITE
        self.coverage = 1
        self.contained = False
        # original read length at each end, carried through merges
        # (Vertex.h:75-76,142-154; updated in Bigraph::merge :180)
        self.origin_length = [len(seq), len(seq)]

    def get_edges(self, dir: int | None = None, sort_by_seqlen: bool = False):
        out = self.edges if dir is None else [e for e in self.edges if e.dir == dir]
        if sort_by_seqlen:
            out = sorted(out, key=lambda e: e.seq_len())
        return out

    def count_edges(self, dir: int | None = None) -> int:
        if dir is None:
            return len(self.edges)
        return sum(1 for e in self.edges if e.dir == dir)

    def remove_edge(self, e: Edge) -> None:
        self.edges.remove(e)

    def merge(self, e: Edge) -> None:
        """Concatenate the label of `e` onto this vertex (Vertex::merge)."""
        twin = e.twin
        label = e.label()
        label_len = len(label)
        e.match_coord.seqlen = len(self.seq) + label_len
        prepend = False
        if e.dir == ED_SENSE:
            self.seq = self.seq + label
        else:
            self.seq = label + self.seq
            prepend = True
        self.coverage += e.end.coverage
        e.match_coord.end += label_len          # extendMatch
        # twin extendMatchFullLength
        if twin.match_coord.is_left_extreme():
            twin.match_coord.end = twin.match_coord.seqlen - 1
        else:
            twin.match_coord.start = 0
        new_len = len(self.seq)
        for ue in self.edges:
            ue.match_coord.seqlen = new_len
            if prepend and ue.dir == ED_SENSE and ue is not e:
                ue.match_coord.start += label_len
                ue.match_coord.end += label_len


class StringGraph:
    """Vertex map + merge/simplify/visit drivers (Bigraph/Bigraph.h)."""

    def __init__(self):
        self.vertices: dict[str, Vertex] = {}
        self.has_containment = False
        self.min_overlap = 0

    # --- construction -----------------------------------------------------
    def add_vertex(self, vid: str, seq: str) -> Vertex:
        v = Vertex(vid, seq)
        self.vertices[vid] = v
        return v

    def get_vertex(self, vid: str) -> Vertex | None:
        return self.vertices.get(vid)

    def remove_vertex(self, v: Vertex) -> None:
        """Remove v and all its edge halves + twins (removeIslandVertex +
        deleteVertex semantics)."""
        for e in list(v.edges):
            other = e.end
            if e.twin in other.edges:
                other.remove_edge(e.twin)
        v.edges.clear()
        del self.vertices[v.id]

    def add_edges_from_overlap(self, o: Overlap, max_edges: int = 2000):
        """createEdgesFromOverlap (StringGraph/SGAlgorithms.cpp:16-100)."""
        v0 = self.get_vertex(o.id[0])
        v1 = self.get_vertex(o.id[1])
        if v0 is None or v1 is None:
            return None
        comp = EC_REVERSE if o.match.is_rc else EC_SAME
        # substring containment: mark contained, no edges
        for idx in range(2):
            if not o.match.coord[idx].is_extreme():
                contained = (v0, v1)[1 - idx]
                contained.color = GC_RED
                contained.contained = True
                self.has_containment = True
                return None
        if v0.count_edges() > max_edges or v1.count_edges() > max_edges:
            return None
        if o.match.is_containment():
            # full-length containment: mark the contained vertex
            cidx = 0 if o.match.coord[0].is_full() else 1
            contained = (v0, v1)[cidx]
            contained.color = GC_RED
            contained.contained = True
            self.has_containment = True
            return None
        e0 = Edge(v0, v1,
                  ED_ANTISENSE if o.match.coord[0].is_left_extreme() else ED_SENSE,
                  comp, o.match.coord[0].copy())
        e1 = Edge(v1, v0,
                  ED_ANTISENSE if o.match.coord[1].is_left_extreme() else ED_SENSE,
                  comp, o.match.coord[1].copy())
        e0.twin, e1.twin = e1, e0
        v0.edges.append(e0)
        v1.edges.append(e1)
        return e0

    # --- merge / simplify -------------------------------------------------
    def merge(self, v1: Vertex, e: Edge) -> None:
        """Merge e.end into v1 across e (Bigraph::merge)."""
        v2 = e.end
        v1.merge(e)
        # the merged end inherits v2's origin length (Bigraph.cpp:179-181)
        v1.origin_length[e.dir] = v2.origin_length[1 - e.twin.dir]
        twin = e.twin
        trans_edges = v2.get_edges(1 - twin.dir)
        for te in trans_edges:
            v2.remove_edge(te)
            te.join(e)
            te.start = v1
            assert te.dir == e.dir
            v1.edges.append(te)
        v1.remove_edge(e)
        v2.remove_edge(twin)
        del self.vertices[v2.id]

    def simplify(self) -> int:
        """Merge unbranched paths (Bigraph::simplify)."""
        merge_count = 0
        for vid in list(self.vertices.keys()):
            v = self.vertices.get(vid)
            if v is None:
                continue
            for dir in (ED_SENSE, ED_ANTISENSE):
                merge_count += self._simplify_vertex(v, dir)
        return merge_count

    def _simplify_vertex(self, v: Vertex, dir: int) -> int:
        merge_count = 0
        edges = v.get_edges(dir)
        while len(edges) == 1:
            single = edges[0]
            if single.is_self():
                break
            twin = single.twin
            w = single.end
            if w.count_edges(twin.dir) != 1:
                break
            self.merge(v, single)
            merge_count += 1
            edges = v.get_edges(dir)
            # drop self edges created by circular merges
            selfs = [e for e in edges if e.is_self()]
            for e in selfs:
                if e.twin in v.edges:
                    v.remove_edge(e.twin)
                if e in v.edges:
                    v.remove_edge(e)
            if selfs:
                edges = v.get_edges(dir)
        return merge_count

    # --- visitor driver ---------------------------------------------------
    def visit(self, visitor) -> bool:
        """Serial visitor pass (Bigraph::visit): previsit, visit each vertex,
        postvisit; returns whether any visit changed the graph."""
        modified = False
        if hasattr(visitor, "previsit"):
            visitor.previsit(self)
        for vid in list(self.vertices.keys()):
            v = self.vertices.get(vid)
            if v is None:
                continue
            modified |= bool(visitor.visit(self, v))
        if hasattr(visitor, "postvisit"):
            visitor.postvisit(self)
        return modified

    def sweep_edges(self, color: int) -> int:
        """Remove all edges whose color matches (Bigraph::sweepEdges)."""
        n = 0
        for v in self.vertices.values():
            keep = []
            for e in v.edges:
                if e.color == color:
                    n += 1
                else:
                    keep.append(e)
            v.edges = keep
        return n

    def sweep_vertices(self, color: int) -> int:
        n = 0
        for vid in list(self.vertices.keys()):
            v = self.vertices[vid]
            if v.color == color:
                self.remove_vertex(v)
                n += 1
        return n

    def stats(self) -> dict:
        nv = len(self.vertices)
        ne = sum(len(v.edges) for v in self.vertices.values()) // 2
        return {"vertices": nv, "edges": ne}

    def rename_vertices(self, prefix: str = "") -> None:
        """Compact vertex ids to prefix + running index
        (Bigraph::renameVertices, Bigraph/Bigraph.h:120)."""
        renamed = {}
        for i, v in enumerate(self.vertices.values()):
            v.id = f"{prefix}{i}"
            renamed[v.id] = v
        self.vertices = renamed

    def write_dot(self, path: str) -> None:
        """Graphviz dump (Bigraph::writeDot, Bigraph/Bigraph.h:133)."""
        with open(path, "w") as fh:
            fh.write("digraph G\n{\n")
            for v in self.vertices.values():
                fh.write(f'{v.id} [ label ="{v.id}" ];\n')
            for v in self.vertices.values():
                for e in v.edges:
                    fh.write(
                        f'{e.start.id} -> {e.end.id} [ label ="{e.dir},{e.comp}" ];\n'
                    )
            fh.write("}\n")
