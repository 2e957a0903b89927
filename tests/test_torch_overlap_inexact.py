"""The port's inexact (-e) overlap engine (graph/overlap_inexact.py):
planted SNP/indel overlaps found with the reference's accounting
(SAIOverlapTree / overlapReadInexactFMWalk); the cases of
tests/test_overlap_inexact.py, each block list also held equal to the JAX
engine's on the same index."""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.graph import overlap as jovl
from longreadselfcorrect_tpu.graph import overlap_inexact as joi
from longreadselfcorrect_tpu.index import host as jhost
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.graph import overlap as ovl
from longreadselfcorrect_tpu_torch.graph.overlap_inexact import overlap_read_inexact_fmwalk
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet

torch.set_num_threads(1)


def blocks_key(blocks):
    return [vars(b) for b in blocks]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    g = "".join(rng.choice(list("ACGT"), size=600))
    r0 = g[0:100]
    r1 = list(g[40:140])
    r1[30] = "ACGT"[("ACGT".index(r1[30]) + 1) % 4]      # SNP in overlap
    r2 = list(g[80:180])
    del r2[70]                                            # 1bp deletion mid-overlap
    r3 = g[120:220]
    seqs = [r0, "".join(r1), "".join(r2), r3]
    fwd, rev = build.build_bwt_pair([ab.encode(s) for s in seqs])
    ix = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings), HostFM(rev.symbols, rev.num_strings))
    jix = jhost.HostIndexSet(jhost.HostFM(fwd.symbols, fwd.num_strings),
                             jhost.HostFM(rev.symbols, rev.num_strings))
    return seqs, (ix, fwd.lex, rev.lex), jix


def inexact_both(corpus, i):
    seqs, (ix, _, _), jix = corpus
    blocks, is_sub = overlap_read_inexact_fmwalk(ix, seqs[i], 40, 0.05, 2)
    jblocks, jis_sub = joi.overlap_read_inexact_fmwalk(jix, seqs[i], 40, 0.05, 2)
    assert (blocks_key(blocks), is_sub) == (blocks_key(jblocks), jis_sub)
    return blocks, is_sub


class TestInexactOverlap:
    def test_snp_overlap_found(self, corpus):
        blocks, is_sub = inexact_both(corpus, 0)
        assert not is_sub
        ols = {(b.overlap_len, b.flags) for b in blocks if b.overlap_len < 100}
        assert (60, ovl.SUF_PRE_AF) in ols  # SNP'd suffix-prefix overlap

    def test_exact_engine_misses_snp(self, corpus):
        seqs, (ix, _, _), jix = corpus
        blocks, _, _ = ovl.overlap_read_exact(ix, seqs[0], 40)
        jblocks, _, _ = jovl.overlap_read_exact(jix, seqs[0], 40)
        assert blocks_key(blocks) == blocks_key(jblocks)
        assert all(b.overlap_len >= 100 for b in blocks)  # only self/containment

    def test_indel_overlap_found_with_coords(self, corpus):
        seqs, (ix, lex_f, lex_r), jix = corpus
        ids = [f"r{i}" for i in range(len(seqs))]
        lens = [len(s) for s in seqs]
        blocks, is_sub = inexact_both(corpus, 3)
        assert not is_sub
        hits, jhits = [], []
        for b in blocks:
            hits += ovl.block_to_overlaps(b, "r3", lens[3], lex_f, lex_r, ids, lens)
            jhits += jovl.block_to_overlaps(b, "r3", lens[3], lex_f, lex_r, ids, lens)
        assert [repr(o) for o in hits] == [repr(o) for o in jhits]
        # r3 overlaps the deletion read r2: target-side span differs by 1
        r2_hits = [o for o in hits if "r2" in o.id]
        assert r2_hits
        o = r2_hits[0]
        c1, c2 = o.match.coord
        assert abs(c1.length() - c2.length()) == 1

    def test_no_inexact_edges_on_clean_exact(self, corpus):
        # a clean exact overlap must also be found by the inexact engine
        blocks, _ = inexact_both(corpus, 2)
        assert any(b.overlap_len < 100 and b.num_diff <= 0 for b in blocks)
