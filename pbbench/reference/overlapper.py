"""Banded pairwise overlap alignment (host engine).

Re-implementation of Overlapper::extendMatch (Thirdparty/overlapper.cpp:
421-700): banded global/overlap DP with free-start boundaries, best score on
the last row/column, and homopolymer-aware tie-breaking in the backtrack.
Column fill is vectorised over the band (the up-chain is a running-max scan).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

INVALID = -(1 << 40)


@dataclass
class SequenceOverlap:
    """Subset of Thirdparty/overlapper.h:80-116."""

    match0_start: int = 0
    match0_end: int = 0
    match1_start: int = 0
    match1_end: int = 0
    length0: int = 0
    length1: int = 0
    score: int = 0
    edit_distance: int = 0
    total_columns: int = 0
    cigar: str = ""  # expanded form (one char per column)

    def percent_identity(self) -> float:
        return (self.total_columns - self.edit_distance) * 100.0 / self.total_columns

    def overlap_length(self) -> int:
        return self.total_columns


def _char_at(s: str, i: int) -> str:
    """C++ std::string::operator[] at size() yields NUL."""
    return s[i] if i < len(s) else "\0"


def fill_cells(
    s1: str,
    s2: str,
    start_1: int,
    start_2: int,
    band_width: int,
    match_score: int = 2,
    gap_penalty: int = -5,
    mismatch_penalty: int = -3,
) -> np.ndarray:
    """The banded cell fill of extendMatch (overlapper.cpp:421-620);
    cells[i, r] is DP cell (i, j = band_origin + i + r)."""
    num_columns = len(s1) + 1
    num_rows = len(s2) + 1
    half = band_width // 2
    bw = half * 2 + 1
    band_origin = start_2 - start_1 + 1 - (half + 1)

    # zero-init matches the reference's uninitialised-as-zero boundaries
    cells = np.zeros((num_columns, bw), dtype=np.int64)
    a1 = np.frombuffer(s1.encode(), dtype=np.uint8)
    a2 = np.frombuffer(s2.encode(), dtype=np.uint8)

    for i in range(1, num_columns):
        j0 = band_origin + i
        j = max(j0, 1)
        end_row = min(j0 + bw, num_rows)
        if end_row <= 0 or j >= num_rows or j >= end_row:
            continue
        rows = np.arange(j, end_row)
        n = len(rows)
        sub = np.where(a2[rows - 1] == a1[i - 1], match_score, mismatch_penalty)
        diag = cells[i - 1, rows - j0] + sub
        left_idx = rows - j0 + 1
        left_ok = left_idx < bw
        left = np.where(
            left_ok, cells[i - 1, np.minimum(left_idx, bw - 1)] + gap_penalty, INVALID
        )
        base = np.maximum(diag, left)
        if n > 1:
            base[n - 1] = diag[n - 1]  # last band row has no left neighbour
        # up-chain within the column: curr[k] = max(base[k], curr[k-1]+gap)
        k = np.arange(n)
        curr = np.maximum.accumulate(base - k * gap_penalty) + k * gap_penalty
        cells[i, rows - j0] = curr
    return cells


def fill_cells_batched(
    s1s: list[str],
    s2s: list[str],
    starts1,
    starts2,
    band_width: int,
    match_score: int = 2,
    gap_penalty: int = -5,
    mismatch_penalty: int = -3,
) -> np.ndarray:
    """fill_cells for N candidate pairs in numpy lockstep.

    One column loop serves every lane ([N, bw] ops per column instead of a
    Python loop per candidate), cell-for-cell identical to fill_cells.
    Returns cells [N, max_cols, bw]; lane n is valid for i <= len(s1s[n]).
    """
    N = len(s1s)
    half = band_width // 2
    bw = half * 2 + 1
    max_q = max((len(s) for s in s1s), default=0)
    max_t = max((len(s) for s in s2s), default=0)
    a1 = np.zeros((N, max_q), np.int16)
    a2 = np.full((N, max_t), -1, np.int16)
    num_rows = np.zeros(N, np.int64)
    origin = np.zeros(N, np.int64)
    for n, (q, t) in enumerate(zip(s1s, s2s)):
        a1[n, : len(q)] = np.frombuffer(q.encode(), dtype=np.uint8)
        a2[n, : len(t)] = np.frombuffer(t.encode(), dtype=np.uint8)
        num_rows[n] = len(t) + 1
        origin[n] = starts2[n] - starts1[n] + 1 - (half + 1)

    cells = np.zeros((N, max_q + 1, bw), np.int64)
    ks = np.arange(bw, dtype=np.int64)
    lanes = np.arange(N)
    for i in range(1, max_q + 1):
        j0 = origin + i                                  # [N]
        rows = j0[:, None] + ks[None, :]                 # [N, bw]
        in_band = (rows >= np.maximum(j0, 1)[:, None]) & (
            rows < np.minimum(j0 + bw, num_rows)[:, None])
        qch = a1[:, i - 1]
        tch = a2[lanes[:, None], np.clip(rows - 1, 0, max(max_t - 1, 0))]
        sub = np.where(tch == qch[:, None], match_score, mismatch_penalty)
        prev = cells[:, i - 1]
        diag = prev + sub
        left = np.concatenate(
            [prev[:, 1:] + gap_penalty,
             np.full((N, 1), INVALID, np.int64)], axis=1)
        n_in = in_band.sum(axis=1)
        first = np.argmax(in_band, axis=1)
        last = first + n_in - 1
        is_last = (ks[None, :] == last[:, None]) & (n_in[:, None] > 1)
        base = np.where(is_last, diag, np.maximum(diag, left))
        shifted = np.where(in_band, base - ks[None, :] * gap_penalty,
                           INVALID)
        run = np.maximum.accumulate(shifted, axis=1)
        curr = run + ks[None, :] * gap_penalty
        cells[:, i] = np.where(in_band, curr, 0)
    return cells


def extend_match(
    s1: str,
    s2: str,
    start_1: int,
    start_2: int,
    band_width: int,
    match_score: int = 2,
    gap_penalty: int = -5,
    mismatch_penalty: int = -3,
    cells: np.ndarray | None = None,
) -> SequenceOverlap:
    num_columns = len(s1) + 1
    num_rows = len(s2) + 1
    half = band_width // 2
    bw = half * 2 + 1
    band_origin = start_2 - start_1 + 1 - (half + 1)

    if cells is None:
        cells = fill_cells(s1, s2, start_1, start_2, band_width,
                           match_score, gap_penalty, mismatch_penalty)

    def score_at(i: int, j: int) -> int:
        r = j - (band_origin + i)
        return int(cells[i, r]) if 0 <= r < bw else INVALID

    out = SequenceOverlap(length0=len(s1), length1=len(s2))

    max_row_value, max_row_index = INVALID - 1, 0
    for i in range(1, num_columns):
        v = score_at(i, num_rows - 1)
        if v > max_row_value:
            max_row_value, max_row_index = v, i
    max_col_value, max_col_index = INVALID - 1, 0
    for j in range(1, num_rows):
        v = score_at(num_columns - 1, j)
        if v > max_col_value:
            max_col_value, max_col_index = v, j

    if max_col_value > max_row_value:
        i, j = num_columns - 1, max_col_index
        out.score = max_col_value
    else:
        i, j = max_row_index, num_rows - 1
        out.score = max_row_value

    out.match0_end = i - 1
    out.match1_end = j - 1

    cigar = []
    while i > 0 and j > 0:
        is_match = s1[i - 1] == s2[j - 1]
        diagonal = score_at(i - 1, j - 1) + (match_score if is_match else mismatch_penalty)
        up = score_at(i, j - 1) + gap_penalty
        left = score_at(i - 1, j) + gap_penalty
        curr = score_at(i, j)
        # tie-break order depends on homopolymer context (overlapper.cpp:625-686)
        if _char_at(s2, j - 1) == _char_at(s2, j):
            order = ("I", "D", "M")
        elif _char_at(s1, i - 1) == _char_at(s1, i):
            order = ("D", "I", "M")
        else:
            order = ("M", "D", "I")
        for op in order:
            if op == "M" and curr == diagonal:
                if not is_match:
                    out.edit_distance += 1
                cigar.append("M")
                i -= 1
                j -= 1
                break
            if op == "D" and curr == left:
                cigar.append("D")
                i -= 1
                out.edit_distance += 1
                break
            if op == "I" and curr == up:
                cigar.append("I")
                j -= 1
                out.edit_distance += 1
                break
        else:
            raise AssertionError("backtrack: no predecessor matches score")
        out.total_columns += 1

    out.match0_start = i
    out.match1_start = j
    out.cigar = "".join(reversed(cigar))
    return out


def compute_overlap(
    s1: str,
    s2: str,
    match_score: int = 2,
    gap_penalty: int = -6,
    mismatch_penalty: int = -3,
) -> SequenceOverlap:
    """Overlapper::computeOverlap (Thirdparty/overlapper.cpp:253-385):
    unbanded overlap DP (zero boundaries, best score on last row/column)
    with default_params {2, -6, -3} (overlapper.cpp:35) and a FIXED
    insertion/deletion/match tie order in the backtrack — unlike
    extendMatch there is no homopolymer conditioning."""
    num_columns = len(s1) + 1
    num_rows = len(s2) + 1
    a1 = np.frombuffer(s1.encode(), dtype=np.uint8)
    a2 = np.frombuffer(s2.encode(), dtype=np.uint8)

    cells = np.zeros((num_columns, num_rows), dtype=np.int64)
    k = np.arange(num_rows, dtype=np.int64)
    for i in range(1, num_columns):
        sub = np.where(a2 == a1[i - 1], match_score, mismatch_penalty)
        base = np.maximum(cells[i - 1, :-1] + sub, cells[i - 1, 1:] + gap_penalty)
        # up-chain: curr[j] = max(base[j], curr[j-1]+gap), curr[0] = 0
        base = np.concatenate(([0], base))
        cells[i] = np.maximum.accumulate(base - k * gap_penalty) + k * gap_penalty

    out = SequenceOverlap(length0=len(s1), length1=len(s2))
    max_row_index = int(np.argmax(cells[1:, num_rows - 1])) + 1
    max_row_value = int(cells[max_row_index, num_rows - 1])
    max_col_index = int(np.argmax(cells[num_columns - 1, 1:])) + 1
    max_col_value = int(cells[num_columns - 1, max_col_index])

    if max_col_value > max_row_value:
        i, j = num_columns - 1, max_col_index
        out.score = max_col_value
    else:
        i, j = max_row_index, num_rows - 1
        out.score = max_row_value

    out.match0_end = i - 1
    out.match1_end = j - 1

    cigar = []
    while i > 0 and j > 0:
        is_match = s1[i - 1] == s2[j - 1]
        up = cells[i, j - 1] + gap_penalty
        left = cells[i - 1, j] + gap_penalty
        curr = cells[i, j]
        if curr == up:
            cigar.append("I")
            j -= 1
            out.edit_distance += 1
        elif curr == left:
            cigar.append("D")
            i -= 1
            out.edit_distance += 1
        else:
            if not is_match:
                out.edit_distance += 1
            cigar.append("M")
            i -= 1
            j -= 1
        out.total_columns += 1

    out.match0_start = i
    out.match1_start = j
    out.cigar = "".join(reversed(cigar))
    return out
