"""kmercheck: k-mer frequency distributions of correct vs erroneous k-mers.

Port of the reference's ground-truth k-mer evaluator (`stride kmercheck`,
StriDe/kmercheck.cpp:77, PacBio/KmerCheckProcess.cpp:12-66): for every
barcode-aligned block of every read and every k in [lower, upper] (step),
classify each k-mer window as correct/erroneous under the barcode's indel
bookkeeping (BCode::validate) and accumulate per-k frequency histograms;
the post-process writes quartile summaries (total.box) and a suggested
frequency threshold per k (value.box) — the reference's tool for tuning
KmerThreshold against a known genome.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import bcode as bc


@dataclass
class KmerDistribution:
    """Util/KmerDistribution.{h,cpp}: int histogram + quartile attributes."""

    data: dict = field(default_factory=dict)
    total: int = 0
    q1: int = 0
    q2: int = 0
    q3: int = 0
    min: int = 0
    max: int = 0
    mode: int = 0
    sdv: float = 0.0

    def add(self, v: int) -> None:
        self.data[v] = self.data.get(v, 0) + 1
        self.total += 1

    def __iadd__(self, other: "KmerDistribution") -> "KmerDistribution":
        for k, n in other.data.items():
            self.data[k] = self.data.get(k, 0) + n
        self.total += other.total
        return self

    def compute_attributes(self) -> None:
        """computeKDAttributes (KmerDistribution.cpp:96-132): quartiles by
        cumulative count, whisker min/max at 1.5*IQR, mode, sd around q2."""
        low = self.total * 1 // 4
        mid = self.total * 2 // 4
        upp = self.total * 3 // 4
        prev = curr = most = 0
        for val in sorted(self.data):
            n = self.data[val]
            if n > most:
                most = n
                self.mode = val
            prev = curr
            curr += n
            if prev <= low <= curr:
                self.q1 = val
            if prev <= mid <= curr:
                self.q2 = val
            if prev <= upp <= curr:
                self.q3 = val
        iqr = self.q3 - self.q1
        small = self.q1 - int(iqr * 1.5)
        large = self.q3 + int(iqr * 1.5)
        prev = curr = 0
        self.min = 0
        self.max = 0
        for val in sorted(self.data):
            prev = curr
            curr = val
            if self.min == 0 and curr >= small:
                self.min = curr
            if prev <= large < curr:
                self.max = prev
        if self.max == 0:
            self.max = curr
        sqsum = sum(n * (val - self.q2) ** 2 for val, n in self.data.items())
        if self.total > 1:
            self.sdv = math.sqrt(sqsum / (self.total - 1))

    def get_cutoff_for_proportion(self, p: float) -> int:
        """getCutoffForProportion (KmerDistribution.cpp:64-82): smallest
        frequency whose cumulative proportion exceeds p (map order)."""
        if not 0 <= p <= 1:
            raise ValueError(p)
        kmer_freq = 0
        cum = 0
        for val in sorted(self.data):
            kmer_freq = val
            cum += self.data[val]
            if cum / self.total > p:
                break
        return kmer_freq

    def __str__(self) -> str:
        return f"{self.min} {self.q1} {self.q2} {self.q3} {self.max}"


def compare_lines(cov: int, ksize: int, crt: KmerDistribution,
                  err: KmerDistribution) -> tuple[str, str]:
    """compare (KmerDistribution.cpp:140-153): the box summary line and the
    suggested per-k frequency threshold."""
    crt.compute_attributes()
    err.compute_attributes()
    total_line = f"{cov} {ksize} | {err} | {crt}"
    if crt.min >= err.max:
        value = crt.min
    else:
        value = crt.q1
    return total_line, f"{cov} {ksize} {value}"


def scan_read(freq_of, seq: str, blocks, lower: int, upper: int, step: int,
              crt_map: dict, err_map: dict) -> None:
    """KmerCheckProcess::scan (KmerCheckProcess.cpp:25-39) over all blocks.

    freq_of(k, pos) -> both-strand frequency of seq[pos:pos+k]."""
    for block in blocks:
        for k in range(lower, upper + 1, step):
            for pos in range(block.start, block.end - k + 1):
                freq = int(freq_of(k, pos))
                if freq <= 1:  # freq==1: the read itself; skip (ref :33)
                    continue
                target = crt_map if bc.validate(pos, k, block, seq) else err_map
                target.setdefault(k, KmerDistribution()).add(freq)
