"""Multiple alignment + consensus, and overlapping-read retrieval (host).

Re-implementation of the MSA fallback path of the self-correction:
* MultipleAlignment / MultipleAlignmentElement — Thirdparty/multiple_alignment
  (padded-row MSA built by stitching pairwise overlaps onto a base row;
  column-majority consensus calculateBaseConsensus at :517-596)
* LongReadOverlap::{retrieveStr, retrieveMatches, buildMultipleAlignment} —
  PacBio/LongReadOverlap.cpp:17-55, 593-662, 667-756
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import alphabet as ab
from .overlapper import SequenceOverlap, extend_match

ALPHABET = "ACGTN-"


def _symbol2index(symbol: str) -> int:
    u = symbol.upper()
    if u == "A":
        return 0
    if u == "C":
        return 1
    if u == "G":
        return 2
    if u == "T":
        return 3
    if u == "-":
        return 5
    return 4


class Element:
    """MultipleAlignmentElement (multiple_alignment.h)."""

    def __init__(self, name: str, padded: str, leading: int, trailing: int):
        self.name = name
        self.padded = padded
        self.leading = leading
        self.trailing = trailing

    def num_columns(self) -> int:
        return self.leading + len(self.padded) + self.trailing

    def start_column(self) -> int:
        return self.leading

    def end_column(self) -> int:
        return self.num_columns() - self.trailing - 1

    def column_symbol(self, col: int) -> str:
        if col < self.leading or col >= self.leading + len(self.padded):
            return "\0"
        return self.padded[col - self.leading]

    def padded_position_of_base(self, idx: int) -> int:
        count = 0
        for i, ch in enumerate(self.padded):
            if ch != "-":
                if count == idx:
                    return i
                count += 1
        raise IndexError(f"base index out of bounds: {idx}")

    def insert_gap_before_column(self, column_index: int) -> None:
        if column_index <= self.leading:
            self.leading += 1
        else:
            pos = column_index - self.leading
            if pos < len(self.padded):
                self.padded = self.padded[:pos] + "-" + self.padded[pos:]
            else:
                self.trailing += 1

    def extend_trailing(self, n: int) -> None:
        self.trailing += n


class MultipleAlignment:
    def __init__(self):
        self.rows: list[Element] = []

    def num_rows(self) -> int:
        return len(self.rows)

    def add_base_sequence(self, name: str, sequence: str) -> None:
        self.rows.append(Element(name, sequence, 0, 0))

    def add_overlap(self, name: str, sequence: str, overlap: SequenceOverlap) -> None:
        assert self.rows
        self._add_sequence(name, sequence, 0, overlap)

    def _add_sequence(self, name: str, sequence: str, template_index_row: int,
                      overlap: SequenceOverlap) -> None:
        """_addSequence (multiple_alignment.cpp:240-380), is_extension=False."""
        template = self.rows[template_index_row]
        padded_output = []
        cigar = overlap.cigar  # expanded
        cigar_index = 0
        template_index = template.padded_position_of_base(overlap.match0_start)
        incoming_index = overlap.match1_start
        template_leading = template.leading
        incoming_leading = template_index + template_leading

        while cigar_index < len(cigar):
            # template.padded may grow via gap insertion; re-read each step
            in_template_gap = template.padded[template_index] == "-"
            if in_template_gap:
                if cigar[cigar_index] == "I":
                    padded_output.append(sequence[incoming_index])
                    incoming_index += 1
                    cigar_index += 1
                    template_index += 1
                else:
                    padded_output.append("-")
                    template_index += 1
            else:
                op = cigar[cigar_index]
                if op == "M":
                    padded_output.append(sequence[incoming_index])
                    incoming_index += 1
                    template_index += 1
                    cigar_index += 1
                elif op == "I":
                    self.insert_gap_before_column(template_index + template_leading)
                    padded_output.append(sequence[incoming_index])
                    incoming_index += 1
                    cigar_index += 1
                    template_index += 1  # skip the introduced gap
                elif op == "D":
                    padded_output.append("-")
                    cigar_index += 1
                    template_index += 1
                elif op == "S":
                    cigar_index += 1
                else:
                    raise ValueError(f"unhandled cigar symbol {op}")

        incoming_trailing = template.num_columns() - len(padded_output) - incoming_leading
        self.rows.append(Element(name, "".join(padded_output), incoming_leading, incoming_trailing))

    def insert_gap_before_column(self, column_index: int) -> None:
        for row in self.rows:
            row.insert_gap_before_column(column_index)

    def column_base_counts(self, col: int) -> list[int]:
        out = [0] * 6
        for row in self.rows:
            s = row.column_symbol(col)
            if s != "\0":
                out[_symbol2index(s)] += 1
        return out

    def calculate_base_consensus(self, min_call_coverage: int, min_trim_coverage: int) -> str:
        """calculateBaseConsensus (multiple_alignment.cpp:517-596)."""
        assert self.rows
        base = self.rows[0]
        consensus: list[str] = []
        last_good_base = -1
        for c in range(base.start_column(), base.end_column() + 1):
            counts = self.column_base_counts(c)
            max_symbol = "\0"
            max_count = -1
            total_depth = 0
            for a, symbol in enumerate(ALPHABET):
                total_depth += counts[a]
                if symbol != "N" and counts[a] > max_count:
                    max_symbol = symbol
                    max_count = counts[a]
            base_symbol = base.column_symbol(c)
            base_count = counts[_symbol2index(base_symbol)]
            if max_count >= base_count and base_count < min_call_coverage:
                consensus_symbol = max_symbol
            else:
                consensus_symbol = base_symbol
            if consensus_symbol != "-" and (consensus or total_depth >= min_trim_coverage):
                consensus.append(consensus_symbol)
            if total_depth >= min_trim_coverage:
                idx = len(consensus) - 1
                if idx > last_good_base:
                    last_good_base = idx
        if last_good_base != -1:
            del consensus[last_good_base + 1:]
        else:
            consensus.clear()
        return "".join(consensus)


# ---------------------------------------------------------------------------
# LongReadOverlap
# ---------------------------------------------------------------------------

_B2C = np.frombuffer(b"$ACGT", dtype=np.uint8)

def _lf_extract(fm, roots: np.ndarray, max_steps: int):
    """Batched LF extraction: the next <= max_steps symbols reached from
    each BWT row (per-row stop at $).  Vectorises retrieveStr's inner
    per-row per-base LF loop (LongReadOverlap.cpp:700-751), which
    serialised every DP gap on the host.
    Returns (mat int8 [N, max_steps], lens [N])."""
    idx = np.asarray(roots, np.int64)
    N = len(idx)
    out = np.zeros((N, max(max_steps, 1)), np.int8)
    alive = np.ones(N, bool)
    lens = np.zeros(N, np.int64)
    for step in range(max_steps):
        if not alive.any():
            break
        b = fm.symbols[idx].astype(np.int64)
        alive = alive & (b != 0)
        out[alive, step] = b[alive]
        lens[alive] += 1
        nxt = fm.pc(b) + fm.occ(b, idx - 1)
        idx = np.where(alive, nxt, idx)
    return out, lens


def _lf_plan(query: str, seed_size: int, max_length: int, ix, is_rc: bool,
             coverage: int):
    """retrieveStr's LF extractions before any is run: (init_kmer, is_rc,
    steps, groups), groups [(strand, roots)] for the RBWT interval of the
    seed k-mer and the BWT interval of its reverse complement, each capped
    at `coverage` rows; empty intervals are left out."""
    if is_rc:
        init_kmer = ab.revcomp_str(query[len(query) - seed_size:])
    else:
        init_kmer = query[:seed_size]

    f_lo, f_hi = (int(x) for x in ix.rbwt.find_interval(ab.encode(init_kmer[::-1])))
    r_lo, r_hi = (int(x) for x in ix.bwt.find_interval(ab.encode(ab.revcomp_str(init_kmer))))
    groups = []
    if f_lo <= f_hi:
        groups.append(("rbwt", np.arange(f_lo, min(f_hi + 1, f_lo + coverage))))
    if r_lo <= r_hi:
        groups.append(("bwt", np.arange(r_lo, min(r_hi + 1, r_lo + coverage))))
    return init_kmer, is_rc, max_length - len(init_kmer), groups


def _retrieve_strs(plans, ix) -> list[list[str]]:
    """The strings of each _lf_plan."""
    got = {}
    for pi, (_, _, steps, groups) in enumerate(plans):
        for gi, (strand, roots) in enumerate(groups):
            got[pi, gi] = _lf_extract(getattr(ix, strand), roots, steps)

    out = []
    for pi, (init_kmer, is_rc, _, groups) in enumerate(plans):
        strs: list[str] = []
        for gi, (strand, roots) in enumerate(groups):
            mat, lens = got[pi, gi]
            for r in range(len(roots)):
                if strand == "rbwt":
                    s = init_kmer + _B2C[mat[r, : lens[r]]].tobytes().decode()
                    strs.append(ab.revcomp_str(s) if is_rc else s)
                else:
                    # the reference PREPENDS each extracted char
                    s = (_B2C[mat[r, : lens[r]][::-1]].tobytes().decode()
                         + ab.revcomp_str(init_kmer))
                    strs.append(s if is_rc else ab.revcomp_str(s))
        out.append(strs)
    return out


def retrieve_str(query: str, seed_size: int, max_length: int, ix, is_rc: bool,
                 coverage: int) -> list[str]:
    """retrieveStr (LongReadOverlap.cpp:667-756): LF-walk extraction of every
    read (capped at `coverage` per strand) containing the query's seed kmer."""
    plan = _lf_plan(query, seed_size, max_length, ix, is_rc, coverage)
    return _retrieve_strs([plan], ix)[0]


def _max_length(query: str) -> int:
    return int(len(query) * 1.1 + 20)


def retrieve_matches(query: str, ovl_str: list[str], k: int, min_overlap: int,
                     min_identity: float, is_rc: bool) -> list[tuple[str, SequenceOverlap]]:
    """retrieveMatches (LongReadOverlap.cpp:593-662) on ovl_str, the
    strings retrieve_str extracts for the same k and strand."""
    bandwidth = 200
    keep: list[str] = []
    for match_sequence in ovl_str:
        if (not is_rc and match_sequence[: len(query)] == query) or (
            is_rc
            and len(match_sequence) >= len(query)
            and match_sequence[len(match_sequence) - len(query):] == query
        ):
            continue
        keep.append(match_sequence)

    cells_all = None
    if is_rc:
        s1 = [len(query) - k] * len(keep)
        s2 = [len(m) - k for m in keep]
    else:
        s1 = [0] * len(keep)
        s2 = [0] * len(keep)
    if len(keep) >= 2:
        # candidate fills in numpy lockstep
        from .overlapper import fill_cells_batched

        cells_all = fill_cells_batched(
            [query] * len(keep), keep, s1, s2, bandwidth, 1, -1, -8)

    out = []
    for n, match_sequence in enumerate(keep):
        cells = None
        if cells_all is not None:
            cells = cells_all[n, : len(query) + 1]
        if is_rc:
            overlap = extend_match(
                query, match_sequence, len(query) - k, len(match_sequence) - k,
                bandwidth, 1, -1, -8, cells=cells,
            )
        else:
            overlap = extend_match(query, match_sequence, 0, 0, bandwidth,
                                   1, -1, -8, cells=cells)
        if overlap.overlap_length() >= min_overlap and overlap.percent_identity() / 100 >= min_identity:
            out.append((match_sequence, overlap))
    return out


def build_multiple_alignment(query: str, src_kmer_length: int, tar_kmer_length: int,
                             min_overlap: int, min_identity: float, coverage: int,
                             ix) -> MultipleAlignment:
    """buildMultipleAlignment (LongReadOverlap.cpp:17-55)."""
    ma = MultipleAlignment()
    ma.add_base_sequence("query", query)
    plans = [_lf_plan(query, k, _max_length(query), ix, is_rc, coverage)
             for k, is_rc in ((src_kmer_length, False), (tar_kmer_length, True))]
    fwd_str, rev_str = _retrieve_strs(plans, ix)
    fwd = retrieve_matches(query, fwd_str, src_kmer_length, min_overlap, min_identity,
                           False)
    rev = retrieve_matches(query, rev_str, tar_kmer_length, min_overlap, min_identity,
                           True)
    for seq, ovl in fwd:
        ma.add_overlap("Src", seq, ovl)
    for seq, ovl in rev:
        ma.add_overlap("Tar", seq, ovl)
    return ma
