"""The port's pbhc (core/hybrid.py, core/stdaln.py): the cases of
tests/test_hybrid.py on synthetic short-read + PacBio data, each result
also held equal to the JAX HybridCorrector's on the same indexes."""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.core import hybrid as jhybrid
from longreadselfcorrect_tpu.index import host as jhost
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core.hybrid import HybridCorrector, HybridParams
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


@pytest.fixture(scope="module")
def sr_index():
    rng = np.random.default_rng(321)
    genome = "".join(rng.choice(list("ACGT"), size=30000))
    reads = []
    for i in range(18000):  # ~60x coverage of 100bp short reads
        p = int(rng.integers(0, len(genome) - 100))
        r = genome[p : p + 100]
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    ix, jix = both_indexes(reads)
    # a small PacBio index (noisy 15%-error long reads over the same genome)
    pb_reads = []
    for i in range(150):  # ~5x of 1kb
        p = int(rng.integers(0, len(genome) - 1000))
        r = list(genome[p : p + 1000])
        for j in range(len(r)):
            if rng.random() < 0.15:
                r[j] = "ACGT"[int(rng.integers(0, 4))]
        pb_reads.append("".join(r))
    pb_ix, jpb_ix = both_indexes(pb_reads)
    return genome, (ix, pb_ix), (jix, jpb_ix), rng


def correct_both(sr_index, rid, seq):
    _, (ix, pb_ix), (jix, jpb_ix), _ = sr_index
    res = HybridCorrector(ix, pb_ix, HybridParams(coverage=60)).correct(rid, seq)
    jres = jhybrid.HybridCorrector(jix, jpb_ix, jhybrid.HybridParams(coverage=60)).correct(rid, seq)
    assert res == jres
    return res


def test_hybrid_corrects_noisy_read(sr_index):
    genome = sr_index[0]
    rng = np.random.default_rng(9)
    truth = genome[10000:11200]
    noisy = []
    for ch in truth:
        r = rng.random()
        if r < 0.06:
            noisy.append("ACGT"[("ACGT".index(ch) + int(rng.integers(1, 4))) % 4])
        elif r < 0.09:
            pass
        elif r < 0.13:
            noisy.append(ch)
            noisy.append("ACGT"[int(rng.integers(0, 4))])
        else:
            noisy.append(ch)
    noisy = "".join(noisy)

    res = correct_both(sr_index, "pb1", noisy)
    assert res["merge"]
    assert res["total_seed_num"] >= 2
    assert res["walk_num"] >= 1
    # the corrected pieces should be near-exact genome substrings
    joined = res["corrected_strs"]
    assert joined
    good = 0
    for piece in joined:
        if piece in genome or ab.revcomp_str(piece) in genome:
            good += 1
    assert good >= max(1, len(joined) // 2), (good, len(joined))
    assert res["corrected_num"] >= 1


def test_hybrid_junk_no_seeds(sr_index):
    rng = np.random.default_rng(10)
    junk = "".join(rng.choice(list("ACGT"), size=600))
    res = correct_both(sr_index, "junk", junk)
    assert not res["merge"]
