"""The port's fm-merge (graph/fmmerge.py): unambiguous tiling reads
collapse into one unitig, branching reads stay unmerged (FMMergeProcess
semantics); the cases of tests/test_fmmerge.py, each merge also held equal
to the JAX FMMerger's on the same index."""
import numpy as np
import torch

from longreadselfcorrect_tpu.graph import fmmerge as jfm
from longreadselfcorrect_tpu.index import host as jhost
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.graph.fmmerge import FMMerger
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet

torch.set_num_threads(1)


def merge_both(reads, min_overlap):
    """The port's FMMerger after merge_all, and its merged records, held
    equal to the JAX FMMerger's on the same BWT."""
    fwd, rev = build.build_bwt_pair([ab.encode(s) for _, s in reads])
    ix = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings), HostFM(rev.symbols, rev.num_strings))
    jix = jhost.HostIndexSet(jhost.HostFM(fwd.symbols, fwd.num_strings),
                             jhost.HostFM(rev.symbols, rev.num_strings))
    m = FMMerger(ix, reads, fwd.lex, rev.lex, min_overlap)
    jm = jfm.FMMerger(jix, reads, fwd.lex, rev.lex, min_overlap)
    out, jout = list(m.merge_all()), list(jm.merge_all())
    assert out == jout
    assert np.array_equal(m.marked, jm.marked)
    return m, out


class TestFMMerge:
    def test_linear_tiling_merges_to_one(self, rng):
        genome = "".join(rng.choice(list("ACGT"), size=300))
        reads = []
        for i, p in enumerate(range(0, 241, 20)):
            r = genome[p : p + 60]
            if i % 2:
                r = ab.revcomp_str(r)
            reads.append((f"r{i}", r))
        m, out = merge_both(reads, 30)
        assert len(out) == 1, [len(s) for _, s in out]
        merged = out[0][1]
        assert merged in (genome, ab.revcomp_str(genome))
        assert m.marked.all()

    def test_branch_stops_merge(self, rng):
        # two genomes sharing a middle segment: reads through the junction
        # cannot merge past it
        core = "".join(rng.choice(list("ACGT"), size=100))
        left_a = "".join(rng.choice(list("ACGT"), size=100))
        left_b = "".join(rng.choice(list("ACGT"), size=100))
        ga = left_a + core
        gb = left_b + core
        reads = []
        k = 0
        for g in (ga, gb):
            for p in range(0, len(g) - 59, 20):
                reads.append((f"r{k}", g[p : p + 60]))
                k += 1
        m, out = merge_both(reads, 30)
        # nothing may span both left_a and left_b
        for _, s in out:
            has_a = any(s.find(left_a[i:i+40]) >= 0 for i in (0, 30, 60))
            has_b = any(s.find(left_b[i:i+40]) >= 0 for i in (0, 30, 60))
            assert not (has_a and has_b)
        # all reads claimed except possibly exact-duplicate strings (the
        # reference pipeline removes those in `filter` before fm-merge;
        # its CAS-discard leaves them unclaimed too, FMMergeProcess.cpp:190)
        unclaimed = [i for i in range(len(reads)) if not m.marked[m.fwd_rank[i]]]
        seqs = [s for _, s in reads]
        for i in unclaimed:
            assert seqs.count(seqs[i]) > 1
