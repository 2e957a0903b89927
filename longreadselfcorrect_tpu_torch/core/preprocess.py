"""Read preprocessing: quality trim / filter / dust / GC screening.

Host-side stream transform mirroring StriDe/preprocess.cpp:362-530 (adapter
removal, ambiguity handling, hard clip, BWA-style soft quality clip, quality
filter, dust filter, GC filter, min-length).
"""
from __future__ import annotations

import random
from dataclasses import dataclass

LOW_QUALITY_PHRED_SCORE = 3

_IUPAC = {
    "M": "AC", "R": "AG", "W": "AT", "S": "CG", "Y": "CT", "K": "GT",
    "V": "ACG", "H": "ACT", "D": "AGT", "B": "CGT", "N": "ACGT",
}


@dataclass
class PreprocessParams:
    """namespace opt of preprocess.cpp:80-100 (subset, same defaults)."""

    quality_trim: int = 0
    hard_clip: int = 0
    min_length: int = 31
    quality_filter: int = -1
    discard_ambiguous: bool = False
    discard_quality: bool = False
    dust: bool = False
    dust_threshold: float = 4.0
    filter_gc: bool = False
    min_gc: float = 0.0
    max_gc: float = 1.0
    adapter_f: str = ""
    adapter_r: str = ""
    phred64: bool = False
    primer_check: bool = False
    pe_mode: int = 0
    sample_freq: float = 1.0
    suffix: str = ""
    seed: int = 0


@dataclass
class PreprocessStats:
    reads_read: int = 0
    reads_kept: int = 0
    bases_read: int = 0
    bases_kept: int = 0
    failed_dust: int = 0
    reads_primer: int = 0
    invalid_pe: int = 0


# Sanger pcr-free library primers (Util/PrimerScreen.cpp:17-18); the screen
# matches the first 14 bases of a read against any substring of these
_PRIMER_DB = (
    "AATGATACGGCGACCACCGAGATCTACA",
    "GATCGGAAGAGCGGTTCAGCAGGAATGC",
)


def contains_primer(seq: str) -> bool:
    """PrimerScreen::containsPrimer (Util/PrimerScreen.cpp:27-43)."""
    check = seq[:14]
    return any(check in p for p in _PRIMER_DB)


def get_pair_id(read_id: str) -> str:
    """getPairID (Util/Util.cpp:388-410): flip the trailing pair marker."""
    if not read_id:
        return ""
    flip = {"A": "B", "B": "A", "1": "2", "2": "1", "f": "r", "r": "f"}
    last = read_id[-1]
    if last not in flip:
        return ""
    return read_id[:-1] + flip[last]


def char2phred(q: str) -> int:
    return ord(q) - 33


def soft_clip(qual_trim: int, seq: str, qual: str) -> tuple[str, str]:
    """BWA-style quality soft clip (preprocess.cpp softClip)."""
    i = len(seq) - 1
    if char2phred(qual[i]) >= qual_trim:
        return seq, qual
    endpoint = 0
    best = 0
    sub_sum = 0
    while i >= 0:
        sub_sum += qual_trim - char2phred(qual[i])
        if sub_sum > best:
            best = sub_sum
            endpoint = i
        i -= 1
    return seq[:endpoint], qual[:endpoint]


def count_low_quality(qual: str) -> int:
    return sum(1 for q in qual if char2phred(q) <= LOW_QUALITY_PHRED_SCORE)


def dust_score(seq: str) -> float:
    """calculateDustScore (Util/Util.cpp:86-112): triplet over-representation."""
    if len(seq) < 3:
        return 0.0
    counts: dict[str, int] = {}
    for i in range(0, len(seq) - 3):
        tri = seq[i : i + 3]
        counts[tri] = counts.get(tri, 0) + 1
    s = sum(c * (c - 1) / 2.0 for c in counts.values())
    return s / (len(seq) - 2)


def process_read(seq: str, qual: str, params: PreprocessParams,
                 stats: PreprocessStats, rng: random.Random) -> tuple[str, str] | None:
    """processRead (preprocess.cpp:362-530); None when the read is dropped."""
    if params.adapter_f:
        found = seq.find(params.adapter_f)
        length = len(params.adapter_f)
        if found < 0 and params.adapter_r:
            found = seq.find(params.adapter_r)
            length = len(params.adapter_r)
        if found >= 0:
            seq = seq[:found] + seq[found + length:]
            if qual:
                qual = qual[:found] + qual[found + length:]

    stats.reads_read += 1
    stats.bases_read += len(seq)

    if not params.discard_ambiguous:
        out = []
        for ch in seq:
            if ch == ".":
                ch = "N"
            if ch in _IUPAC:
                ch = _IUPAC[ch][rng.randrange(len(_IUPAC[ch]))]
            out.append(ch)
        seq = "".join(out)

    for ch in seq:
        if ch not in "ACGT":
            return None

    if qual and not params.discard_quality and params.phred64:
        qual = "".join(chr(ord(q) - 31) for q in qual)

    if params.hard_clip > 0:
        seq = seq[: params.hard_clip]
        qual = qual[: params.hard_clip]

    if params.quality_trim > 0 and qual:
        seq, qual = soft_clip(params.quality_trim, seq, qual)

    if params.quality_filter >= 0 and qual:
        if count_low_quality(qual) > params.quality_filter:
            return None

    if params.dust:
        if dust_score(seq) >= params.dust_threshold:
            stats.failed_dust += 1
            return None

    if params.filter_gc and seq:
        gc = sum(1 for c in seq if c in "GC") / len(seq)
        if gc < params.min_gc or gc > params.max_gc:
            return None

    if params.primer_check and contains_primer(seq):
        stats.reads_primer += 1
        return None

    if params.discard_quality:
        qual = ""

    if len(seq) == 0 or len(seq) < params.min_length:
        return None

    # kept counting happens at the caller (the main loop, preprocess.cpp:
    # 222-321): PE orphans and sampled-out reads pass here but are not kept
    return seq, qual
