"""Host-side multi-string BWT construction.

Builds the BWT of a read collection under the SGA/StriDe convention
(reference: SuffixTools/BWTCARopebwt.cpp, SuffixTools/SACAInducedCopying.h):

* every read is terminated by its own ``$``;
* ``$`` sorts below A<C<G<T and the sentinels of different reads are ordered
  by read index;
* ``BWT[j]`` is the in-string predecessor of suffix ``SA[j]`` (so the suffix
  that is a whole read is preceded by that read's ``$``, emitted as rank 0).

The construction here concatenates reads with *distinct* sentinel values that
encode the read index, builds a suffix array by numpy prefix doubling, and
reads the BWT off it.  This is O(n log n) with vectorised numpy sorts — fine
for tests and medium inputs; the C++ SA-IS builder in ``native/`` takes over
for large read sets (see fmbuild).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import alphabet as ab


def _suffix_array_int(text: np.ndarray) -> np.ndarray:
    """Suffix array of an integer array via prefix doubling (Manber-Myers)."""
    n = len(text)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # initial ranks = values (any order-preserving map works)
    rank = np.unique(text, return_inverse=True)[1].astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        pair = np.stack([rank[order], second[order]], axis=1)
        new_head = np.ones(n, dtype=bool)
        new_head[1:] = np.any(pair[1:] != pair[:-1], axis=1)
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = np.cumsum(new_head) - 1
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order
        k *= 2
    return idx  # unreachable


SSA_SAMPLE_RATE = 64  # DEFAULT_SA_SAMPLE_RATE (SuffixTools/SampledSuffixArray.h:71)


@dataclass
class BWTData:
    """Raw BWT of a read collection in rank space."""

    symbols: np.ndarray   # int8 [n_total] values in {0..4}
    num_strings: int
    num_symbols: int      # == len(symbols)
    # optional SA side-products (set when the builder had the full SA):
    lex: np.ndarray | None = None   # u32 [ns] read id per lexicographic rank
    ssa: np.ndarray | None = None   # u32 [n_samples, 2] (id, offset) per sampled row
    ssa_rate: int = SSA_SAMPLE_RATE

    @property
    def counts(self) -> np.ndarray:
        return np.bincount(self.symbols, minlength=ab.ALPHABET_SIZE).astype(np.int64)


def multi_string_bwt(reads: list[np.ndarray]) -> BWTData:
    """BWT of the read set (reads are int8 rank arrays WITHOUT terminators)."""
    n_reads = len(reads)
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    assert np.all(lens > 0), "empty reads are not allowed"
    total = int(lens.sum()) + n_reads
    # distinct sentinels: read i's terminator gets value i, bases get n_reads+rank
    text = np.empty(total, dtype=np.int64)
    starts = np.zeros(n_reads, dtype=np.int64)
    pos = 0
    for i, r in enumerate(reads):
        starts[i] = pos
        text[pos : pos + len(r)] = r.astype(np.int64) + n_reads
        text[pos + len(r)] = i
        pos += len(r) + 1
    sa = _suffix_array_int(text)
    # predecessor in the same string: position p>start -> text[p-1];
    # p == start of read i -> that read's '$' (rank 0)
    is_start = np.zeros(total, dtype=bool)
    is_start[starts] = True
    pred = np.empty(total, dtype=np.int64)
    pred[1:] = text[:-1]
    pred[0] = 0
    bwt = np.where(is_start[sa], 0, pred[sa] - n_reads)
    bwt = np.where(bwt < 0, 0, bwt)  # predecessor was a sentinel -> '$'
    # SA side-products (same layout as native/fmbuild.cpp): read id + offset
    # of every suffix, read off the full SA while we have it
    read_of = np.searchsorted(starts, sa, side="right") - 1
    off_of = sa - starts[read_of]
    lex = read_of[is_start[sa]].astype(np.uint32)
    n_samples = total // SSA_SAMPLE_RATE + 1
    ssa = np.full((n_samples, 2), 0xFFFFFFFF, dtype=np.uint32)
    rows = np.arange(0, total, SSA_SAMPLE_RATE)
    ssa[: len(rows), 0] = read_of[rows]
    ssa[: len(rows), 1] = off_of[rows]
    return BWTData(symbols=bwt.astype(np.int8), num_strings=n_reads,
                   num_symbols=total, lex=lex, ssa=ssa)


def build_bwt_pair(reads: list[np.ndarray]) -> tuple[BWTData, BWTData]:
    """(BWT, RBWT): BWT of the reads and of the per-read-reversed reads.

    Mirrors `stride index` building .bwt from the reads and .rbwt from each
    read reversed (SuffixTools/BWTCARopebwt.cpp:160-247).
    """
    fwd = multi_string_bwt(reads)
    rev = multi_string_bwt([r[::-1].copy() for r in reads])
    return fwd, rev


def naive_bwt(reads: list[str]) -> str:
    """Tiny O(n^2 log n) oracle used by tests: explicit suffix sort."""
    suffixes = []  # (key, read_idx, pos)
    for i, r in enumerate(reads):
        s = r + "$"
        for p in range(len(s)):
            # key: characters with $ replaced by a tuple ordering (0, read idx)
            key = tuple(
                (0, i) if ch == "$" else ("$ACGT".index(ch), -1) for ch in s[p:]
            )
            suffixes.append((key, i, p))
    suffixes.sort()
    out = []
    for _, i, p in suffixes:
        s = reads[i] + "$"
        out.append(s[p - 1] if p > 0 else s[-1])
    return "".join(out)
