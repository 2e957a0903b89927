"""The port's MSA/DP fallback equals the JAX package's, exactly.

The plain versions of the two MSA kernels (ops/msa_kernels.py) are held
against the JAX package's msa_kernels functions and its host loops
(core/msa._lf_extract, core/overlapper.fill_cells) on the indexes of
tests/test_msa.py's TestDeviceMSAKernels; the port's device route of
build_multiple_alignment and its BatchedSelfCorrector, with the size
gates at 0 so that every DP fallback takes that route, are held against
the JAX host path.  Tolerance 0: the outputs are symbols and integer DP
cells.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.core import msa as jmsa
from longreadselfcorrect_tpu.core.correct import CorrectionParams as JParams
from longreadselfcorrect_tpu.core.correct import SelfCorrector as JSelfCorrector
from longreadselfcorrect_tpu.core.overlapper import extend_match as jextend_match
from longreadselfcorrect_tpu.core.overlapper import fill_cells as jfill_cells
from longreadselfcorrect_tpu.index import build as jbuild
from longreadselfcorrect_tpu.index.fmindex import FMIndex as JFMIndex
from longreadselfcorrect_tpu.index.fmindex import IndexSet as JIndexSet
from longreadselfcorrect_tpu.index.host import HostFM as JHostFM
from longreadselfcorrect_tpu.index.host import HostIndexSet as JHostIndexSet
from longreadselfcorrect_tpu.ops import msa_kernels as jmk
from longreadselfcorrect_tpu_torch import cli
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core import msa
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.index.fmindex import FMIndex, IndexSet
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.io import fasta
from longreadselfcorrect_tpu_torch.ops import msa_kernels, walk

torch.set_num_threads(1)

COUNTERS = ("merge", "corrected_strs", "total_reads_len", "corrected_len",
            "total_seed_num", "total_walk_num", "high_error_num",
            "exceed_depth_num", "exceed_leave_num", "fm_num", "dp_num", "seed_dis")


def noisify(rng, s, e):
    """test_batch_correct.noisy_reads' error model (substitutions 60%,
    deletions 20%, insertions 20%) on a given stretch: reads shorter than
    its 1.2 kb keep the DP test within ~20 s."""
    out = []
    for ch in s:
        r = rng.random()
        if r < e * 0.6:
            out.append("ACGT"[("ACGT".index(ch) + int(rng.integers(1, 4))) % 4])
        elif r < e * 0.8:
            pass
        elif r < e:
            out.append(ch)
            out.append("ACGT"[int(rng.integers(0, 4))])
        else:
            out.append(ch)
    return "".join(out)


@pytest.fixture(scope="module")
def dix():
    """tests/test_msa.py's TestDeviceMSAKernels index (genome rng 202, 120
    reads of 400 bp, half reverse-complemented) in both packages, from the
    same symbol arrays."""
    rng = np.random.default_rng(202)
    genome = "".join(rng.choice(list("ACGT"), size=5000))
    reads = []
    for i in range(120):
        p = int(rng.integers(0, 5000 - 400))
        r = genome[p : p + 400]
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    fwd, rev = jbuild.build_bwt_pair([ab.encode(r) for r in reads])
    jhix = JHostIndexSet(JHostFM(fwd.symbols, fwd.num_strings),
                         JHostFM(rev.symbols, rev.num_strings))
    jdev = JIndexSet(bwt=JFMIndex.from_symbols(fwd.symbols, fwd.num_strings),
                     rbwt=JFMIndex.from_symbols(rev.symbols, rev.num_strings))
    hix = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings),
                       HostFM(rev.symbols, rev.num_strings))
    pdev = IndexSet(bwt=FMIndex.from_symbols(fwd.symbols, fwd.num_strings, "cpu"),
                    rbwt=FMIndex.from_symbols(rev.symbols, rev.num_strings, "cpu"))
    return genome, jhix, jdev, hix, pdev


def counting(monkeypatch, name):
    """Count the calls of msa_kernels.<name> (a plain version)."""
    calls = []
    orig = getattr(msa_kernels, name)

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(msa_kernels, name, wrapped)
    return calls


@pytest.mark.parametrize("strand", ["bwt", "rbwt"])
@pytest.mark.parametrize("roots,max_steps", [
    (np.arange(5, 40), 60),
    (np.arange(0, 37 * 97, 97), 1),            # N = 37, spread over the SA
    (np.arange(3, 40), 450),                    # past every read's '$'
], ids=["rows5-40-steps60", "n37-steps1", "n37-past-dollar"])
def test_lf_extract_plain_matches_jax(dix, monkeypatch, strand, roots, max_steps):
    _, jhix, jdev, _, pdev = dix
    calls = counting(monkeypatch, "lf_extract_plain")
    got_m, got_l = msa_kernels.lf_extract(getattr(pdev, strand), roots, max_steps)
    assert calls and got_m.dtype == np.int8 and got_l.dtype == np.int64
    want_m, want_l = jmk.lf_extract(getattr(jdev, strand), roots, max_steps)
    host_m, host_l = jmsa._lf_extract(getattr(jhix, strand), roots, max_steps)
    assert np.array_equal(got_l, want_l) and np.array_equal(got_l, host_l)
    assert np.array_equal(got_m, want_m) and np.array_equal(got_m, host_m)
    if max_steps == 450:
        assert (got_l < max_steps).all() and (got_m[:, -1] == 0).all()


def test_lf_extract_groups_plain_matches_jax(dix, monkeypatch):
    """The grouped entry (one launch per multiple alignment on the card):
    groups on both BWTs with their own max_steps, an empty one among
    them, equal to the JAX lf_extract group by group."""
    _, _, jdev, _, pdev = dix
    calls = counting(monkeypatch, "lf_extract_plain")
    jobs = [("rbwt", np.arange(5, 40), 60), ("bwt", np.arange(0), 30),
            ("bwt", np.arange(3, 40), 450), ("rbwt", np.arange(0, 37 * 97, 97), 1)]
    got = msa_kernels.lf_extract_groups(pdev, jobs)
    assert len(calls) == 3   # the empty group is not extracted
    for (strand, roots, steps), (m, l) in zip(jobs, got):
        want_m, want_l = jmk.lf_extract(getattr(jdev, strand), roots, steps)
        assert m.dtype == np.int8 and l.dtype == np.int64
        assert np.array_equal(m, want_m) and np.array_equal(l, want_l), (strand, steps)


def fill_lanes(genome):
    """test_msa.py:226-254's lanes (planted noise and indels, every third
    anchored at the ends as the rc call sites are), plus one lane whose
    band leaves its short target (empty columns)."""
    rng = np.random.default_rng(7)
    queries, targets, s1s, s2s = [], [], [], []
    for i in range(6):
        p = int(rng.integers(0, 4000))
        q = genome[p : p + 150 + i * 17]
        t = list(genome[p : p + 160 + i * 11])
        for j in range(0, len(t), 23):
            t[j] = "ACGT"[int(rng.integers(0, 4))]
        if i % 2:
            del t[40]
        targets.append("".join(t))
        queries.append(q)
        if i % 3 == 2:
            s1s.append(len(q) - 19)
            s2s.append(len(targets[-1]) - 19)
        else:
            s1s.append(0)
            s2s.append(0)
    queries.append(genome[300:560])
    targets.append(genome[300:340])
    s1s.append(0)
    s2s.append(0)
    return queries, targets, s1s, s2s


@pytest.mark.parametrize("band_width", [10, 31, 200])
def test_banded_fill_plain_matches_jax(dix, monkeypatch, band_width):
    genome = dix[0]
    queries, targets, s1s, s2s = fill_lanes(genome)
    calls = counting(monkeypatch, "banded_fill_plain")
    got = msa_kernels.banded_fill(queries, targets, s1s, s2s, band_width,
                                  (1, -1, -8), device="cpu")
    assert calls and got.dtype == np.int32
    bw = 2 * (band_width // 2) + 1
    assert got.shape == (len(queries), max(map(len, queries)) + 1, bw)
    want = jmk.banded_fill(queries, targets, s1s, s2s, band_width, (1, -1, -8))
    empty = 0
    for n, (q, t) in enumerate(zip(queries, targets)):
        cells = got[n, : len(q) + 1]
        assert np.array_equal(cells, want[n, : len(q) + 1]), n
        assert np.array_equal(cells, jfill_cells(q, t, s1s[n], s2s[n], band_width,
                                                  1, -1, -8)), n
        a = jextend_match(q, t, s1s[n], s2s[n], band_width, 1, -1, -8)
        b = jextend_match(q, t, s1s[n], s2s[n], band_width, 1, -1, -8, cells=cells)
        assert (a.cigar, a.score) == (b.cigar, b.score), n
        empty += int((cells[1:] == 0).all(axis=1).sum())
    assert empty > 0   # the last lane's band left its target


@pytest.mark.parametrize("p,length", [(1000, 700), (2600, 450)])
def test_device_route_msa_matches_jax_host(dix, monkeypatch, p, length):
    """The port's build_multiple_alignment with a CPU IndexSet as dev= and
    both gates at 0 against the JAX host build_multiple_alignment
    (test_msa.py:256-268)."""
    genome, jhix, _, hix, pdev = dix
    monkeypatch.setattr(msa, "LF_DEVICE_MIN", 0)
    monkeypatch.setattr(msa, "FILL_DEVICE_MIN", 0)
    lf = counting(monkeypatch, "lf_extract_plain")
    fill = counting(monkeypatch, "banded_fill_plain")
    query = genome[p : p + length]
    ma_j = jmsa.build_multiple_alignment(query, 19, 19, length // 10, 0.65, 120, jhix)
    ma_p = msa.build_multiple_alignment(query, 19, 19, length // 10, 0.65, 120, hix,
                                        dev=pdev)
    assert lf and fill
    assert ma_p.num_rows() == ma_j.num_rows() > 3
    cj = ma_j.calculate_base_consensus(15, -1)
    assert ma_p.calculate_base_consensus(15, -1) == cj and cj


@pytest.fixture(scope="module")
def repeat_corpus(tmp_path_factory):
    """A 10 kb genome with a 40 bp element at 40 places (an interspersed
    repeat), 30x of exact 1 kb reads on both strands, indexed through the
    port's CLI; walks that cross the element exceed their leaves and fall
    back to the MSA/DP path."""
    rng = np.random.default_rng(1)
    base = "".join(rng.choice(list("ACGT"), size=8000))
    elem = "".join(rng.choice(list("ACGT"), size=40))
    cuts = sorted(rng.choice(np.arange(100, 7900), size=40, replace=False))
    parts, last = [], 0
    for c in cuts:
        parts += [base[last:c], elem]
        last = c
    genome = "".join(parts) + base[last:]
    d = tmp_path_factory.mktemp("dp")
    reads_fa = str(d / "reads.fa")
    with open(reads_fa, "w") as fh:
        for i in range(len(genome) * 30 // 1000):
            p = rng.integers(0, len(genome) - 1000)
            r = genome[p : p + 1000]
            fasta.write_fasta(fh, f"c{i}", ab.revcomp_str(r) if i % 2 else r)
    prefix = str(d / "reads")
    assert cli.main(["index", reads_fa, "-p", prefix, "--pure-python"]) == 0
    hix, dix = open_index(prefix, device="cpu")
    jhix = JHostIndexSet(JHostFM(hix.bwt.symbols, hix.bwt.num_strings),
                         JHostFM(hix.rbwt.symbols, hix.rbwt.num_strings))
    return genome, hix, dix, jhix


def test_batched_dp_route_matches_jax_host(repeat_corpus, monkeypatch):
    """The slice as a whole: the port's BatchedSelfCorrector on reads at 15%
    error, every DP fallback through the plain kernels, equal to the JAX
    host SelfCorrector in every counter."""
    genome, hix, dix, jhix = repeat_corpus
    monkeypatch.setattr(msa, "LF_DEVICE_MIN", 0)
    monkeypatch.setattr(msa, "FILL_DEVICE_MIN", 0)
    lf = counting(monkeypatch, "lf_extract_plain")
    fill = counting(monkeypatch, "banded_fill_plain")
    rng = np.random.default_rng(2028)
    items = []
    for i in range(2):
        p = int(rng.integers(0, len(genome) - 800))
        items.append((f"r{i}", noisify(rng, genome[p : p + 800], 0.15)))
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(pb_coverage=30, genome=10),
                                cfg=walk.WalkConfig(G=64, MAXLEN=640, QMAX=640,
                                                    WSCAN=320))
    assert port.msa_dev is port.dix
    got = port.process_batch(items)
    host = JSelfCorrector(jhix, JParams(pb_coverage=30, genome=10))
    for (rid, seq), res in zip(items, got):
        want = host.process(rid, seq)
        for name in COUNTERS:
            assert getattr(res, name) == getattr(want, name), (rid, name)
    assert any(r.dp_num > 0 for r in got)
    assert lf and fill


def test_merged_launch_msa_matches_jax_host(repeat_corpus, monkeypatch):
    """build_multiple_alignment with a CPU IndexSet as dev= extracts the
    four root sets of its two seeds (different k) as one grouped call,
    and equals the JAX host build_multiple_alignment, on queries that
    carry the 40 bp element."""
    genome, hix, dix, jhix = repeat_corpus
    monkeypatch.setattr(msa, "LF_DEVICE_MIN", 0)
    monkeypatch.setattr(msa, "FILL_DEVICE_MIN", 0)
    grouped = counting(monkeypatch, "lf_extract_groups")
    starts = {}
    for i in range(len(genome) - 40):
        starts.setdefault(genome[i : i + 40], []).append(i)
    elem = max(starts.values(), key=len)
    assert len(elem) >= 30
    for p in elem[3:5]:
        query = genome[p - 110 : p + 150]
        ma_j = jmsa.build_multiple_alignment(query, 19, 17, 26, 0.65, 30, jhix)
        n = len(grouped)
        ma_p = msa.build_multiple_alignment(query, 19, 17, 26, 0.65, 30, hix, dev=dix)
        assert len(grouped) == n + 1
        assert ma_p.num_rows() == ma_j.num_rows() > 3
        assert (ma_p.calculate_base_consensus(15, -1)
                == ma_j.calculate_base_consensus(15, -1))
