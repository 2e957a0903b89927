"""Short-read k-mer error correction (`stride correct -a kmer`).

Re-implementation of ErrorCorrectProcess::kmerCorrection +
attemptKmerCorrection (Algorithm/ErrorCorrectProcess.cpp:287-540) and
CorrectionThresholds (Util/CorrectionThresholds.cpp): mark read positions not
covered by any solid k-mer, then correct the leftmost weak base to the allele
whose covering k-mer count is >= 2x the support threshold.

The per-round count sweep over all read k-mers is one vectorised batch query
(the reference caches scalar FM counts per k-mer, ErrorCorrectProcess.cpp:349).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import alphabet as ab

DEFAULT_QUAL_SCORE = 15


@dataclass
class CorrectionThresholds:
    """Util/CorrectionThresholds.cpp defaults."""

    min_support_low_quality: int = 4
    min_support_high_quality: int = 3
    high_quality_cutoff: int = 20

    def set_base_min_support(self, ms: int) -> None:
        self.min_support_high_quality = ms
        self.min_support_low_quality = ms + 1

    def required_support(self, phred: int) -> int:
        if phred >= self.high_quality_cutoff:
            return self.min_support_high_quality
        return self.min_support_low_quality


@dataclass
class KmerCorrectParams:
    kmer_length: int = 31
    num_kmer_rounds: int = 10
    thresholds: CorrectionThresholds = None

    def __post_init__(self):
        if self.thresholds is None:
            self.thresholds = CorrectionThresholds()


def _batch_counts(ix, seq: str, k: int) -> np.ndarray:
    """Both-strand counts of every k-mer of seq (vectorised)."""
    enc = ab.encode(seq)
    win = np.lib.stride_tricks.sliding_window_view(enc, k)
    lo1, hi1 = ix.bwt.find_interval(win)
    rc = ab.complement(win)[:, ::-1]
    lo2, hi2 = ix.bwt.find_interval(rc)
    return (np.maximum(hi1 - lo1 + 1, 0) + np.maximum(hi2 - lo2 + 1, 0)).astype(np.int64)


def _count_one(ix, kmer: str) -> int:
    return ix.bwt.count_occurrences_both_strands(ab.encode(kmer))


def kmer_correct(ix, seq: str, qual: str, params: KmerCorrectParams) -> tuple[str, bool]:
    """Returns (corrected_sequence, kmer_qc)."""
    k = params.kmer_length
    n = len(seq)
    if n < k:
        return seq, False
    nk = n - k + 1

    def phred(i: int) -> int:
        return (ord(qual[i]) - 33) if qual else DEFAULT_QUAL_SCORE

    # min phred per kmer window
    ph = np.array([phred(i) for i in range(n)])
    min_phred = np.array(
        [ph[i : i + k].min() for i in range(nk)]
    )
    th = params.thresholds
    req = np.array([th.required_support(int(p)) for p in min_phred])

    read = seq
    rounds = 0
    all_solid = False
    while nk > 0:
        counts = _batch_counts(ix, read, k)
        solid = np.zeros(n, dtype=bool)
        for i in range(nk):
            if counts[i] >= req[i]:
                solid[i : i + k] = True
        all_solid = bool(solid.all())
        if all_solid or rounds > params.num_kmer_rounds:
            break
        rounds += 1

        corrected = False
        for i in range(n):
            if solid[i]:
                continue
            threshold = th.required_support(phred(i))
            left_k = i + 1 - k if i + 1 >= k else 0
            new = _attempt(ix, read, i, left_k, max(int(counts[left_k]), threshold), k)
            if new is not None:
                read = new
                corrected = True
                break
            right_k = min(i, n - k)
            new = _attempt(ix, read, i, right_k, max(int(counts[right_k]), threshold), k)
            if new is not None:
                read = new
                corrected = True
                break
        if not corrected:
            break

    if all_solid:
        return read, True
    return seq, False


def _attempt(ix, read: str, i: int, k_idx: int, min_count: int, k: int) -> str | None:
    """attemptKmerCorrection (:488-540)."""
    base_idx = i - k_idx
    original = read[i]
    kmer = list(read[k_idx : k_idx + k])
    best_count = 0
    best_base = "$"
    for cur in "ACGT":
        kmer[base_idx] = cur
        count = _count_one(ix, "".join(kmer))
        if count >= min_count * 2:
            best_count = count
            best_base = cur
    if best_count >= min_count * 2 and best_base != original:
        return read[:i] + best_base + read[i + 1:]
    return None
