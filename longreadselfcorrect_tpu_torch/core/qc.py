"""Read QC filtering (`stride filter`).

k-mer QC from Algorithm/QCProcess.cpp:96-205: a read passes when EVERY k-mer
(both strands) occurs strictly more than `threshold` times.  The reference
walks a growing interval window as a speed trick; the accept/reject semantics
equal the all-kmers test, which we evaluate as one vectorised count sweep.

Duplicate/substring removal from QCProcess::performDuplicateCheck
(Algorithm/QCProcess.cpp:206-266): a read is a SUBSTRING when any occurrence
of it (either strand) extends by a DNA character left or right; otherwise
full-length copies dedup by an atomic claim of the canonical lexicographic
rank (min of the fwd/rc '$'-interval lowers) in a BitVector sized
num_strings (StriDe/filter.cpp:137-140).  Serial claim order here equals
read-stream order — deterministic, matching `filter -t 1`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import alphabet as ab


@dataclass
class QCParams:
    kmer_length: int = 31
    kmer_threshold: int = 3
    check_kmer: bool = True
    check_duplicates: bool = True
    substring_only: bool = False


def kmer_qc(ix, seq: str, params: QCParams) -> bool:
    """performKmerCheck semantics: all k-mer counts > threshold."""
    k = params.kmer_length
    if len(seq) < k:
        return False
    enc = ab.encode(seq)
    win = np.lib.stride_tricks.sliding_window_view(enc, k)
    lo1, hi1 = ix.bwt.find_interval(win)
    rc = ab.complement(win)[:, ::-1]
    lo2, hi2 = ix.bwt.find_interval(rc)
    counts = np.maximum(hi1 - lo1 + 1, 0) + np.maximum(hi2 - lo2 + 1, 0)
    return bool((counts > params.kmer_threshold).all())


def _ext_count_has_dna(fm, lo, hi) -> bool:
    """getExtCount(interval, fm).hasDNAChar(): any non-'$' char in
    BWT[lo..hi] (BWTAlgorithms::getExtCount == occ_all(hi) - occ_all(lo-1))."""
    if lo > hi:
        return False
    syms = np.arange(1, 5, dtype=np.int64)
    cnt = fm.occ(syms, np.full(4, hi, np.int64)) - fm.occ(syms, np.full(4, lo - 1, np.int64))
    return bool((cnt > 0).any())


def duplicate_check(ix, seq: str, shared_bv: np.ndarray) -> str:
    """performDuplicateCheck (QCProcess.cpp:206-266).

    Returns 'UNIQUE' | 'SUBSTRING' | 'DUP'.  `shared_bv` is the claim
    BitVector over lexicographic ranks (bool [num_strings])."""
    enc = ab.encode(seq)
    rc = ab.reverse_complement(enc)
    # interval pair: [0] = interval of w in BWT, [1] = interval of rev(w) in RBWT
    f0 = ix.bwt.find_interval(enc)
    f1 = ix.rbwt.find_interval(enc[::-1])
    r0 = ix.bwt.find_interval(rc)
    r1 = ix.rbwt.find_interval(rc[::-1])
    if (
        _ext_count_has_dna(ix.bwt, int(f0[0]), int(f0[1]))
        or _ext_count_has_dna(ix.rbwt, int(f1[0]), int(f1[1]))
        or _ext_count_has_dna(ix.bwt, int(r0[0]), int(r0[1]))
        or _ext_count_has_dna(ix.rbwt, int(r1[0]), int(r1[1]))
    ):
        return "SUBSTRING"
    # updateBothL('$', pBWT): lexicographic rank range of reads equal to w
    big = np.iinfo(np.int64).max
    fi = ri = big
    flo, fhi = ix.bwt.update_interval(int(f0[0]), int(f0[1]), 0)
    if flo <= fhi:
        fi = int(flo)
    rlo, rhi = ix.bwt.update_interval(int(r0[0]), int(r0[1]), 0)
    if rlo <= rhi:
        ri = int(rlo)
    canonical = min(fi, ri)
    if canonical == big:
        return "UNIQUE"  # defensive: read absent from the index
    if not shared_bv[canonical]:
        shared_bv[canonical] = True
        return "UNIQUE"
    return "DUP"


def filter_reads(ix, records, params: QCParams):
    """Yield (record, passed) pairs, mirroring QCProcess::process ordering
    (dup check gates the k-mer check, QCProcess.cpp:55-80)."""
    shared_bv = (
        np.zeros(ix.bwt.num_strings, bool) if params.check_duplicates else None
    )
    for rec in records:
        if params.check_duplicates:
            dcr = duplicate_check(ix, rec.seq, shared_bv)
            dup_passed = (dcr != "SUBSTRING") if params.substring_only else (dcr == "UNIQUE")
        else:
            dup_passed = True
        if params.check_kmer and dup_passed:
            passed = kmer_qc(ix, rec.seq, params)
        else:
            passed = dup_passed
        yield rec, passed


def median_kmer_frequency(ix, k: int, sample: int = 100000) -> int:
    """Median both-strand k-mer frequency of the corpus.

    The reference samples 100k random k-mers from the reverse BWT
    (BWTAlgorithms::sampleKmerCounts, BWTAlgorithms.cpp) and takes the
    distribution's q2; this deterministic variant extracts k-mers from
    evenly spaced BWT rows instead of rand() rows, so the repeat cutoff it
    feeds (median*1.3, FMIndexWalkProcess.cpp:403) is reproducible."""
    import numpy as np

    from . import alphabet as ab
    from .msa import _lf_extract

    fm = ix.rbwt
    n_rows = fm.n
    n = min(sample, max(n_rows // 4, 1))
    roots = np.linspace(0, n_rows - 1, n).astype(np.int64)
    mat, lens = _lf_extract(fm, roots, k)
    full = lens >= k
    if not np.any(full):
        return 1
    kmers = mat[full][:, :k].astype(np.int64)
    # counts in the rbwt text + its reverse complement == both strands
    lo, hi = fm.find_interval(kmers[:, ::-1])
    c1 = np.maximum(hi - lo + 1, 0)
    lo, hi = ix.bwt.find_interval(ab.complement(kmers)[:, ::-1])
    c2 = np.maximum(hi - lo + 1, 0)
    counts = np.sort(c1 + c2)
    return int(counts[len(counts) // 2])
