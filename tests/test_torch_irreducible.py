"""The port's irreducible-overlap classification (graph/overlap.py,
computeIrreducibleBlocks, Algorithm/OverlapAlgorithm.cpp:1060-1190):
transitive blocks must vanish; the cases of tests/test_irreducible.py,
each block list also held equal to the JAX engine's on the same index."""
import torch

from longreadselfcorrect_tpu.graph import overlap as jovl
from longreadselfcorrect_tpu.index import host as jhost
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.graph import overlap as ovl
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet

torch.set_num_threads(1)


def build_ix(reads):
    fwd, rev = build.build_bwt_pair([ab.encode(s) for _, s in reads])
    return (HostIndexSet(HostFM(fwd.symbols, fwd.num_strings),
                         HostFM(rev.symbols, rev.num_strings)),
            jhost.HostIndexSet(jhost.HostFM(fwd.symbols, fwd.num_strings),
                               jhost.HostFM(rev.symbols, rev.num_strings)),
            fwd.lex, rev.lex)


def exact_both(ix, jix, seq, **kw):
    """overlap_read_exact of both packages: the port's blocks, held equal
    to the JAX ones field for field."""
    blocks = ovl.overlap_read_exact(ix, seq, 20, **kw)
    jblocks = jovl.overlap_read_exact(jix, seq, 20, **kw)
    for got, want in zip(blocks[:2], jblocks[:2]):
        assert [vars(b) for b in got] == [vars(b) for b in want]
    assert blocks[2] == jblocks[2]
    return blocks[0]


def staircase(rng, n=5, read_len=60, step=15):
    genome = "".join(rng.choice(list("ACGT"), size=read_len + step * (n - 1)))
    reads = [(f"r{i}", genome[i * step : i * step + read_len]) for i in range(n)]
    return genome, reads


class TestIrreducible:
    def test_transitive_blocks_removed(self, rng):
        # r0..r4 tile the genome; r0 overlaps r1 (45) and r2 (30, transitive)
        genome, reads = staircase(rng)
        ix, jix, lex_f, lex_r = build_ix(reads)
        ids = [r[0] for r in reads]
        lens = [len(s) for _, s in reads]

        exhaustive = exact_both(ix, jix, reads[0][1])
        irr = exact_both(ix, jix, reads[0][1], irreducible=True)
        def targets(blocks):
            out = set()
            for b in blocks:
                for o in ovl.block_to_overlaps(b, "r0", lens[0], lex_f, lex_r, ids, lens):
                    out.add((o.id[0], o.id[1], o.match.coord[0].length()))
                # canonical filter drops (query < target); count raw ranks too
                lex = lex_r if b.flags[1] else lex_f
                for j in range(b.lo, b.hi + 1):
                    out.add(("raw", ids[int(lex[j])], b.overlap_len))
            return out

        ex_t = {t for t in targets(exhaustive) if t[0] == "raw"}
        irr_t = {t for t in targets(irr) if t[0] == "raw"}
        assert ("raw", "r1", 45) in ex_t
        assert ("raw", "r2", 30) in ex_t
        assert ("raw", "r1", 45) in irr_t
        assert ("raw", "r2", 30) not in irr_t  # transitive through r1

    def test_rc_irreducible_found(self, rng):
        genome, reads = staircase(rng, n=3)
        # flip the middle read: the r0-r1 overlap is now reverse-complement
        reads[1] = (reads[1][0], ab.revcomp_str(reads[1][1]))
        ix, jix, lex_f, lex_r = build_ix(reads)
        ids = [r[0] for r in reads]
        irr = exact_both(ix, jix, reads[0][1], irreducible=True)
        found = set()
        for b in irr:
            lex = lex_r if b.flags[1] else lex_f
            for j in range(b.lo, b.hi + 1):
                found.add((ids[int(lex[j])], b.overlap_len))
        assert ("r1", 45) in found
        assert ("r2", 30) not in found
