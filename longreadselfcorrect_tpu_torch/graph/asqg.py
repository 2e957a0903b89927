"""ASQG graph file format (SQG/ASQG.cpp).

Line-oriented, tab-separated records, transparently gzipped:

    HT\tVN:i:1\tER:f:<err>\tOL:i:<minOverlap>\tIN:Z:<infile>\tCN:i:<contain>\tTE:i:<transitive>
    VT\t<id>\t<seq>[\tSS:i:1]
    ED\t<id0> <id1> <s1> <e1> <l1> <s2> <e2> <l2> <rc> <numDiff>

(HeaderRecord/VertexRecord/EdgeRecord::write, SQG/ASQG.cpp:118-254.)
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass

from .core import Overlap, StringGraph


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


@dataclass
class Header:
    version: int = 1
    error_rate: float = 0.0
    min_overlap: int = 0
    infile: str = ""
    containment: int = 1
    transitive: int = 1

    def to_line(self) -> str:
        return ("HT\tVN:i:{}\tER:f:{:g}\tOL:i:{}\tIN:Z:{}\tCN:i:{}\tTE:i:{}"
                .format(self.version, self.error_rate, self.min_overlap,
                        self.infile, self.containment, self.transitive))


def write_vertex(fh, vid: str, seq: str, is_substring: bool = False) -> None:
    if is_substring:
        fh.write(f"VT\t{vid}\t{seq}\tSS:i:1\n")
    else:
        fh.write(f"VT\t{vid}\t{seq}\n")


def write_edge(fh, o: Overlap) -> None:
    fh.write(f"ED\t{o.to_line()}\n")


def load(path: str, min_overlap: int = 0, allow_containments: bool = True,
         max_edges: int = 2000) -> StringGraph:
    """SGUtil::loadASQG (vertex pass + edge pass in one sweep here; the
    reference splits them only for parallel loading, SGUtil.h:24-31)."""
    g = StringGraph()
    substrings = []
    with _open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            tag = line[:2]
            if tag == "HT":
                for f in line.split("\t")[1:]:
                    if f.startswith("OL:i:"):
                        g.min_overlap = int(f[5:])
            elif tag == "VT":
                fields = line.split("\t")
                vid, seq = fields[1], fields[2]
                is_sub = any(f.startswith("SS:i:") and f[5:] != "0" for f in fields[3:])
                if is_sub:
                    substrings.append(vid)
                    continue  # substring reads never enter the graph
                g.add_vertex(vid, seq)
            elif tag == "ED":
                o = Overlap.from_line(line.split("\t", 1)[1])
                if o.match.coord[0].length() < min_overlap:
                    continue
                if not allow_containments and o.match.is_containment():
                    continue
                g.add_edges_from_overlap(o, max_edges)
    return g


def write(path: str, g: StringGraph, header: Header | None = None) -> None:
    with _open(path, "w") as fh:
        fh.write((header or Header()).to_line() + "\n")
        for v in g.vertices.values():
            write_vertex(fh, v.id, v.seq)
        seen = set()
        for v in g.vertices.values():
            for e in v.edges:
                key = id(e.twin) if id(e.twin) < id(e) else id(e)
                if key in seen:
                    continue
                seen.add(key)
                fh.write(f"ED\t{Overlap((e.start.id, e.end.id), e.get_match()).to_line()}\n")
