"""The port's short-read pipeline pieces (core/preprocess.py,
core/kmer_correct.py, core/overlap_correct.py, core/pe_merge.py): the cases
of tests/test_shortread.py on the port's copies, each direct result also
held equal to the JAX package's on the same input and index."""
import random

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.core import kmer_correct as jkc
from longreadselfcorrect_tpu.core import overlap_correct as joc
from longreadselfcorrect_tpu.core import pe_merge as jpm
from longreadselfcorrect_tpu.core import preprocess as jpp
from longreadselfcorrect_tpu.index import host as jhost
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core import preprocess as pp
from longreadselfcorrect_tpu_torch.core.kmer_correct import KmerCorrectParams, kmer_correct
from longreadselfcorrect_tpu_torch.core.pe_merge import merge_pair, validate_read
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet

# the index builds are numpy; one torch thread keeps the parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)


def both_indexes(reads):
    """The port's HostIndexSet over the reads and the JAX package's over
    the same BWT symbols."""
    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    ix = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings), HostFM(rev.symbols, rev.num_strings))
    jix = jhost.HostIndexSet(jhost.HostFM(fwd.symbols, fwd.num_strings),
                             jhost.HostFM(rev.symbols, rev.num_strings))
    return ix, jix


def process_both(seq, qual, **kw):
    """process_read of both packages: (port result, port stats)."""
    stats, jstats = pp.PreprocessStats(), jpp.PreprocessStats()
    out = pp.process_read(seq, qual, pp.PreprocessParams(**kw), stats, random.Random(1))
    jout = jpp.process_read(seq, qual, jpp.PreprocessParams(**kw), jstats, random.Random(1))
    assert out == jout
    assert vars(stats) == vars(jstats)
    return out, stats


class TestPreprocess:
    def test_clean_read_passes(self):
        out, _ = process_both("ACGT" * 20, "I" * 80)
        assert out == ("ACGT" * 20, "I" * 80)

    def test_short_read_dropped(self):
        out, _ = process_both("ACGTACGT", "I" * 8)
        assert out is None

    def test_quality_soft_clip(self):
        seq = "ACGT" * 20
        qual = "I" * 60 + "#" * 20  # low-quality tail
        out, _ = process_both(seq, qual, quality_trim=20)
        assert out is not None
        assert len(out[0]) == 60

    def test_dust_filters_low_complexity(self):
        out, stats = process_both("A" * 80, "", dust=True)
        assert out is None
        assert stats.failed_dust == 1

    def test_ambiguity_resolved(self):
        out, _ = process_both("ACGTN" * 10 + "ACGTACGTAC", "")
        assert out is not None
        assert "N" not in out[0]

    def test_ambiguity_discarded_by_default_flag(self):
        out, _ = process_both("ACGTN" * 10 + "ACGTACGTAC", "", discard_ambiguous=True)
        assert out is None

    def test_primer_screen(self):
        seq = "AATGATACGGCGAC" + "ACGT" * 20  # 14bp prefix of primer A
        out, stats = process_both(seq, "", primer_check=True)
        assert out is None
        assert stats.reads_primer == 1

    def test_get_pair_id(self):
        for rid, want in (("read/1", "read/2"), ("read/B", "read/A"),
                          ("readf", "readr"), ("readX", "")):
            assert pp.get_pair_id(rid) == want == jpp.get_pair_id(rid)


class TestPreprocessPE:
    """PE interleave/orphan routing via the port's CLI (preprocess.cpp:233-321),
    its files equal to the JAX CLI's."""

    def _write_pairs(self, tmp_path):
        rng = random.Random(5)
        r1 = tmp_path / "r1.fq"
        r2 = tmp_path / "r2.fq"
        il = tmp_path / "il.fq"
        with open(r1, "w") as f1, open(r2, "w") as f2, open(il, "w") as fi:
            for i in range(8):
                s1 = "".join(rng.choice("ACGT") for _ in range(60))
                s2 = "".join(rng.choice("ACGT") for _ in range(60))
                q2 = "#" * 60 if i == 2 else "I" * 60  # pair 2: mate fails
                f1.write(f"@p{i}/1\n{s1}\n+\n{'I' * 60}\n")
                f2.write(f"@p{i}/2\n{s2}\n+\n{q2}\n")
                fi.write(f"@p{i}/1\n{s1}\n+\n{'I' * 60}\n")
                fi.write(f"@p{i}/2\n{s2}\n+\n{q2}\n")
        return r1, r2, il

    def test_pe_mode1_and_mode2_agree(self, tmp_path):
        from longreadselfcorrect_tpu import cli as jcli
        from longreadselfcorrect_tpu_torch import cli

        r1, r2, il = self._write_pairs(tmp_path)
        files = {}
        for name, main in (("port", cli.main), ("jax", jcli.main)):
            out1, out2 = tmp_path / f"{name}1.fq", tmp_path / f"{name}2.fq"
            orph1, orph2 = tmp_path / f"{name}o1.fq", tmp_path / f"{name}o2.fq"
            assert main(["preprocess", "-p", "1", "-q", "20", "--pe-orphans", str(orph1),
                         "-o", str(out1), str(r1), str(r2)]) == 0
            assert main(["preprocess", "-p", "2", "-q", "20", "--pe-orphans", str(orph2),
                         "-o", str(out2), str(il)]) == 0
            files[name] = [p.read_text() for p in (out1, out2, orph1, orph2)]
        assert files["port"] == files["jax"]
        body, body2, orph, orph2 = files["port"]
        assert body == body2
        assert orph == orph2
        # pair 2 dropped from the main output, its good half orphaned
        assert "@p2/1" not in body and "@p2/2" not in body
        assert "@p2/1" in orph
        # survivors are interleaved /1,/2
        ids = [l for l in body.splitlines() if l.startswith("@p")]
        assert ids[0].endswith("/1") and ids[1].endswith("/2")
        assert ids[0][:-2] == ids[1][:-2]


@pytest.fixture(scope="module")
def sr_corpus():
    rng = np.random.default_rng(123)
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    reads = []
    for i in range(4000):  # ~20x coverage of 100bp reads
        p = int(rng.integers(0, len(genome) - 100))
        r = genome[p : p + 100]
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    ix, jix = both_indexes(reads)
    return genome, reads, ix, jix


class TestKmerCorrect:
    def _both(self, ix, jix, seq):
        out = kmer_correct(ix, seq, "", KmerCorrectParams(kmer_length=21))
        assert out == jkc.kmer_correct(jix, seq, "", jkc.KmerCorrectParams(kmer_length=21))
        return out

    def test_single_error_corrected(self, sr_corpus):
        genome, reads, ix, jix = sr_corpus
        truth = genome[5000:5100]
        noisy = truth[:50] + "ACGT"[("ACGT".index(truth[50]) + 1) % 4] + truth[51:]
        out, qc = self._both(ix, jix, noisy)
        assert qc
        assert out == truth

    def test_clean_read_untouched(self, sr_corpus):
        genome, reads, ix, jix = sr_corpus
        truth = genome[8000:8100]
        out, qc = self._both(ix, jix, truth)
        assert qc
        assert out == truth


class TestOverlapCorrect:
    def _both(self, ix, jix, seq):
        # rank -> read-id map; without it the LF backtrack's $-rank would be
        # misread as a read id and the wrong sequences extracted
        from longreadselfcorrect_tpu_torch.core.overlap_correct import overlap_correction
        from longreadselfcorrect_tpu_torch.index.host import build_lexico_index

        out = overlap_correction(ix, build_lexico_index(ix.bwt), None, seq, 31, 1, 0.96, 3)
        jout = joc.overlap_correction(jix, jhost.build_lexico_index(jix.bwt), None, seq,
                                      31, 1, 0.96, 3)
        assert out == jout
        return out

    def test_clean_read_untouched(self, sr_corpus):
        genome, reads, ix, jix = sr_corpus
        truth = genome[4000:4100]
        out, qc = self._both(ix, jix, truth)
        assert qc
        assert out == truth

    def test_clustered_errors_corrected(self, sr_corpus):
        # two nearby substitutions defeat the single-base k-mer fix and force
        # the MSA consensus path (ErrorCorrectProcess.cpp:83-283)
        genome, reads, ix, jix = sr_corpus
        truth = genome[7000:7100]
        bad = list(truth)
        for p in (48, 52):
            bad[p] = "ACGT"[("ACGT".index(bad[p]) + 1) % 4]
        out, qc = self._both(ix, jix, "".join(bad))
        assert qc
        assert out == truth

    def test_extract_read_inverts_bwt(self, sr_corpus):
        from longreadselfcorrect_tpu_torch.core.overlap_correct import extract_read
        genome, reads, ix, jix = sr_corpus
        # $-sector row i is read i's own terminator (distinct sentinels)
        for rid in (0, 1, 17, 3999):
            assert extract_read(ix, rid) == reads[rid] == joc.extract_read(jix, rid)


class TestPEMerge:
    def test_merge_gap_pair(self, sr_corpus):
        genome, reads, ix, jix = sr_corpus
        # fragment of 260bp: read1 = first 100, read2 = last 100 (fwd orientation)
        frag = genome[3000:3260]
        r1 = frag[:100]
        r2_rc = frag[160:260]  # already in read1 orientation
        kw = dict(min_overlap=31, max_overlap=61, max_insert=400, sa_threshold=3)
        code, merged = merge_pair(ix, r1, r2_rc, **kw)
        assert (code, merged) == jpm.merge_pair(jix, r1, r2_rc, **kw)
        assert code == 1
        assert merged == frag

    def test_validate_good_read(self, sr_corpus):
        genome, reads, ix, jix = sr_corpus
        seq = genome[6000:6200]
        code, out = validate_read(ix, seq, min_overlap=31, sa_threshold=3)
        assert (code, out) == jpm.validate_read(jix, seq, min_overlap=31, sa_threshold=3)
        assert code == 1
        assert out == seq

    def test_validate_bad_read_fails(self, sr_corpus):
        genome, reads, ix, jix = sr_corpus
        bad = genome[6000:6090] + ab.revcomp_str(genome[9000:9110])  # chimera
        code, out = validate_read(ix, bad, min_overlap=31, sa_threshold=3)
        assert (code, out) == jpm.validate_read(jix, bad, min_overlap=31, sa_threshold=3)
        assert code != 1 or out != bad


class TestKmerizeHybrid:
    def _ix(self, rng):
        genome = "".join(rng.choice(list("ACGT"), size=5000))
        reads = []
        for i in range(1500):  # 30x of 100bp
            p = int(rng.integers(0, 5000 - 100))
            r = genome[p : p + 100]
            reads.append(ab.revcomp_str(r) if i % 2 else r)
        return (genome,) + both_indexes(reads)

    def test_split_read_clean_read_stays_whole(self):
        from longreadselfcorrect_tpu_torch.core.pe_merge import split_read
        genome, ix, jix = self._ix(np.random.default_rng(77))
        clean = genome[1000:1100]
        main_idx, pieces = split_read(ix, clean, 31, 2)
        assert (main_idx, pieces) == jpm.split_read(jix, clean, 31, 2)
        assert len(pieces) == 1 and main_idx == 0
        assert pieces[0] == clean

    def test_split_read_error_read_splits(self):
        from longreadselfcorrect_tpu_torch.core.pe_merge import kmerize_read
        genome, ix, jix = self._ix(np.random.default_rng(78))
        bad = list(genome[2000:2100])
        bad[50] = "ACGT"[("ACGT".index(bad[50]) + 1) % 4]
        bad = "".join(bad)
        ok, main, others = kmerize_read(ix, bad, 31, 2)
        assert (ok, main, others) == jpm.kmerize_read(jix, bad, 31, 2)
        assert ok
        pieces = ([main] if main else []) + others
        assert len(pieces) >= 2
        # every piece must be a genomic substring after the error split
        for p in pieces:
            ing = p in genome or ab.revcomp_str(p) in genome
            has_err = genome[2000:2100][:len(p)] != p
            assert ing or has_err

    def test_merge_and_kmerize_merges_clean_pair(self):
        from longreadselfcorrect_tpu_torch.core.pe_merge import merge_and_kmerize
        genome, ix, jix = self._ix(np.random.default_rng(79))
        frag = genome[3000:3300]  # insert 300
        r1 = frag[:100]
        r2 = ab.revcomp_str(frag[-100:])
        args = (r1, r2, 31, 2, 31, 95, 500, 32)
        res = merge_and_kmerize(ix, *args, repeat_freq=1000)
        assert res == jpm.merge_and_kmerize(jix, *args, repeat_freq=1000)
        assert res["merge"], res
        got = res["seq"]
        assert got in (frag, ab.revcomp_str(frag)) or frag in got
