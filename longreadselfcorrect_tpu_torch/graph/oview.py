"""oview: draw the overlaps of reads from an ASQG file.

Port of `stride oview` (StriDe/oview.cpp:73-124) over
Util/MultiOverlap.cpp:26-48,589-637: per root read, stack every
overlapping read at its alignment offset and print the reference's
row format `<padded seq>\\t<overlap_len>\\t<num_diff>\\t<score>\\tID:<id>`.
"""
from __future__ import annotations

from ..core import alphabet as ab
from .asqg import _open
from .core import Overlap


def parse_asqg(path: str):
    """oview's parseASQG (oview.cpp:126-160): reads + per-read overlaps."""
    reads: dict[str, str] = {}
    omap: dict[str, list[Overlap]] = {}
    with _open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n")
            tag = line[:2]
            if tag == "VT":
                f = line.split("\t")
                reads[f[1]] = f[2]
            elif tag == "ED":
                o = Overlap.from_line(line.split("\t", 1)[1])
                omap.setdefault(o.id[0], []).append(o)
                omap.setdefault(o.id[1], []).append(o)
    return reads, omap


def _swap(o: Overlap) -> Overlap:
    return Overlap((o.id[1], o.id[0]),
                   type(o.match)((o.match.coord[1], o.match.coord[0]),
                                 o.match.is_rc, o.match.num_diff))


def _count_differences(match, s1: str, s2: str) -> int:
    """Match::countDifferences (Util/Match.cpp:267-276)."""
    m1 = match.coord[0].substring(s1)
    m2 = match.coord[1].substring(s2)
    if match.is_rc:
        m2 = ab.revcomp_str(m2)
    return sum(a != b for a, b in zip(m1, m2))


def _print_row(out, default_padding: int, max_overhang: int, root_len: int,
               offset: int, overlap_len: int, nd: int, score: float,
               seq: str, rid: str) -> None:
    """MultiOverlap::printRow (MultiOverlap.cpp:611-637)."""
    c_len = len(seq)
    left_clip = max(offset, -max_overhang)
    right_clip = min(offset + c_len, root_len + max_overhang)
    t_left_clip = left_clip - offset
    t_right_clip = right_clip - offset
    padding = default_padding + left_clip
    leader = "..." if t_left_clip > 0 else ""
    trailer = "..." if t_right_clip < c_len else ""
    clipped = seq[t_left_clip:t_right_clip]
    padding -= len(leader)
    outstr = " " * max(padding, 0) + leader + clipped + trailer
    out.write(f"{outstr}\t{overlap_len}\t{nd}\t{score:f}\tID:{rid}\n")


def draw_alignment(out, root_id: str, reads: dict, omap: dict,
                   default_padding: int = 20, max_overhang: int = 20) -> None:
    """drawAlignment (oview.cpp:102-124) + MultiOverlap::print."""
    root_seq = reads[root_id]
    rows = []
    for o in omap.get(root_id, ()):
        if o.id[0] != root_id:
            o = _swap(o)
        seq = reads[o.id[1]]
        m = o.match
        if m.is_rc:  # canonize: RC the sequence into the root frame
            seq = ab.revcomp_str(seq)
            c1 = m.coord[1].flipped()
            m = type(m)((m.coord[0], c1), False, m.num_diff)
        offset = m.coord[0].start - m.coord[1].start
        rows.append((offset, seq, m, o.id[1]))
    rows.sort(key=lambda r: r[0])

    out.write(f"\nDrawing overlaps for read {root_id}\n")
    root_len = len(root_seq)
    _print_row(out, default_padding, max_overhang, root_len, 0, root_len,
               0, 0.0, root_seq, root_id)
    for offset, seq, m, rid in rows:
        overlap_len = max(m.coord[0].length(), m.coord[1].length())
        nd = _count_differences(m, root_seq, seq)
        _print_row(out, default_padding, max_overhang, root_len, offset,
                   overlap_len, nd, nd / overlap_len, seq, rid)
