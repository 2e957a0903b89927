"""The port's duplicate/substring removal (core/qc.py,
QCProcess::performDuplicateCheck, Algorithm/QCProcess.cpp:206-266): the
cases of tests/test_filter_dup.py against a brute-force oracle, each
classification also held equal to the JAX module's."""
import numpy as np
import torch

from longreadselfcorrect_tpu.core import qc as jqc
from longreadselfcorrect_tpu.index import host as jhost
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core.qc import QCParams, duplicate_check, filter_reads
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet

torch.set_num_threads(1)


def make_ix(reads):
    """The port's HostIndexSet and the JAX package's over the same BWT."""
    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    return (HostIndexSet(HostFM(fwd.symbols, fwd.num_strings),
                         HostFM(rev.symbols, rev.num_strings)),
            jhost.HostIndexSet(jhost.HostFM(fwd.symbols, fwd.num_strings),
                               jhost.HostFM(rev.symbols, rev.num_strings)))


class Rec:
    def __init__(self, i, seq):
        self.id = f"r{i}"
        self.seq = seq


def brute_classify(reads):
    """Expected outcome per read, processed in stream order."""
    rc = [ab.revcomp_str(r) for r in reads]
    out = []
    claimed = set()
    for i, r in enumerate(reads):
        # substring of any longer read, either strand
        is_sub = any(
            (r in other or rc[i] in other) and len(other) > len(r)
            for other in reads
        )
        if is_sub:
            out.append("SUBSTRING")
            continue
        key = min(r, rc[i])
        if key in claimed:
            out.append("DUP")
        else:
            claimed.add(key)
            out.append("UNIQUE")
    return out


def check_both(reads):
    """duplicate_check over the reads in stream order, held equal to the
    JAX duplicate_check's (and the claimed-read bit vectors)."""
    ix, jix = make_ix(reads)
    bv = np.zeros(ix.bwt.num_strings, bool)
    jbv = np.zeros(jix.bwt.num_strings, bool)
    got = [duplicate_check(ix, r, bv) for r in reads]
    assert got == [jqc.duplicate_check(jix, r, jbv) for r in reads]
    assert np.array_equal(bv, jbv)
    return got


def filter_both(reads, **kw):
    ix, jix = make_ix(reads)
    recs = [Rec(i, r) for i, r in enumerate(reads)]
    got = [p for _, p in filter_reads(ix, recs, QCParams(**kw))]
    assert got == [p for _, p in jqc.filter_reads(jix, recs, jqc.QCParams(**kw))]
    return got


class TestDuplicateCheck:
    def test_planted_duplicates(self):
        reads = [
            "ACGTACGTACGTACGTAAAACCCC",   # unique
            "ACGTACGTACGTACGTAAAACCCC",   # exact dup of 0
            "CATCATGGGTTTACACACAGGATG",   # unique
            ab.revcomp_str("ACGTACGTACGTACGTAAAACCCC"),  # rc dup of 0
            "CGTACGTACGTACGTAAAACCC",     # substring of 0
            "TTTTGGGGCATCATCATCATCATT",   # unique
        ]
        got = check_both(reads)
        assert got == ["UNIQUE", "DUP", "UNIQUE", "DUP", "SUBSTRING", "UNIQUE"]

    def test_random_corpus_vs_oracle(self, rng):
        base = [
            "".join(rng.choice(list("ACGT"), size=int(rng.integers(15, 40))))
            for _ in range(12)
        ]
        reads = list(base)
        reads.append(base[0])                     # exact dup
        reads.append(ab.revcomp_str(base[1]))     # rc dup
        reads.append(base[2][2:-3])               # substring
        reads.append(ab.revcomp_str(base[3])[1:]) # rc substring
        got = check_both(reads)
        want = brute_classify(reads)
        assert got == want

    def test_filter_pipeline_substring_only(self):
        reads = [
            "ACGTACGTACGTACGTAAAACCCC",
            "ACGTACGTACGTACGTAAAACCCC",
            "CGTACGTACGTACGTAAAACCC",
        ]
        got = filter_both(reads, check_kmer=False, substring_only=True)
        assert got == [True, True, False]  # full-length dups kept, substring dropped
        got = filter_both(reads, check_kmer=False, substring_only=False)
        assert got == [True, False, False]
