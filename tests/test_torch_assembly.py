"""The port's overlap + string-graph assembly (graph/*): synthetic
error-free reads must assemble back into the source sequence (overlap ->
ASQG -> assemble passes mirror StriDe/overlap.cpp + StriDe/assemble.cpp);
the cases of tests/test_assembly.py, each overlap list, graph (vertex and
edge sets), walk and CLI output also held equal to the JAX package's on
the same input."""
import io

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.graph import asqg as jasqg
from longreadselfcorrect_tpu.graph import overlap as jovl
from longreadselfcorrect_tpu.graph import visitors as jvis
from longreadselfcorrect_tpu.graph.core import StringGraph as JStringGraph
from longreadselfcorrect_tpu.index import host as jhost
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.graph import asqg, overlap as ovl
from longreadselfcorrect_tpu_torch.graph.core import StringGraph
from longreadselfcorrect_tpu_torch.graph.visitors import (
    ContainRemoveVisitor, TransitiveReductionVisitor, TrimVisitor, contig_stats)
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.host import HostFM, HostIndexSet

torch.set_num_threads(1)


def make_corpus(rng, genome_len=600, read_len=80, step=20):
    genome = "".join(rng.choice(list("ACGT"), size=genome_len))
    reads = []
    for i, p in enumerate(range(0, genome_len - read_len + 1, step)):
        r = genome[p : p + read_len]
        if i % 3 == 1:
            r = ab.revcomp_str(r)
        reads.append((f"r{i}", r))
    return genome, reads


def build_ix(reads):
    """(port index, JAX index over the same BWT, lex_fwd, lex_rev)."""
    fwd, rev = build.build_bwt_pair([ab.encode(s) for _, s in reads])
    ix = HostIndexSet(HostFM(fwd.symbols, fwd.num_strings),
                      HostFM(rev.symbols, rev.num_strings))
    jix = jhost.HostIndexSet(jhost.HostFM(fwd.symbols, fwd.num_strings),
                             jhost.HostFM(rev.symbols, rev.num_strings))
    return ix, jix, fwd.lex, rev.lex


def graph_state(g):
    """A string graph's vertex set and edge set, comparable across the two
    packages."""
    verts = sorted((v.id, v.seq) for v in g.vertices.values())
    edges = sorted((e.start.id, e.end.id, e.dir, e.comp, repr(e.match_coord))
                   for v in g.vertices.values() for e in v.edges)
    return verts, edges


def overlap_both(ix, jix, reads, min_overlap, lex_f, lex_r, **kw):
    """overlap_all of both packages: the port's vertices (id, seq,
    is_sub), edges and stats, held equal to the JAX ones."""
    out = []
    for mod, index in ((ovl, ix), (jovl, jix)):
        verts, edges = [], []
        stats = mod.overlap_all(index, reads, min_overlap, lex_f, lex_r,
                                on_vertex=lambda *a: verts.append(a),
                                on_edge=edges.append, **kw)
        out.append((verts, edges, stats))
    (verts, edges, stats), (jverts, jedges, jstats) = out
    assert (verts, stats) == (jverts, jstats)
    assert [o.to_line() for o in edges] == [o.to_line() for o in jedges]
    return verts, edges


def write_asqg(path, verts, edges, min_overlap):
    with asqg._open(path, "w") as fh:
        fh.write(asqg.Header(min_overlap=min_overlap).to_line() + "\n")
        for v in verts:
            asqg.write_vertex(fh, *v)
        for o in edges:
            asqg.write_edge(fh, o)


def naive_overlaps(reads, min_overlap):
    """Brute-force suffix/prefix overlap oracle over both strands.

    Returns the set of canonical (idA, idB, overlap_len, rc) tuples with
    id0 > id1 (the reference's duplicate filter keeps id[0] > id[1],
    StriDe/OverlapCommon.cpp:66)."""
    out = set()
    for ida, a in reads:
        for idb, b in reads:
            if ida == idb:
                continue
            for brc, rc in ((b, False), (ab.revcomp_str(b), True)):
                for ol in range(min_overlap, min(len(a), len(brc)) + 1):
                    if ol == len(a) or ol == len(brc):
                        continue  # containment handled separately
                    if a[-ol:] == brc[:ol]:       # suffix(a) = prefix(b')
                        if ida > idb:
                            out.add((ida, idb, ol, rc, "sp"))
                    if brc[-ol:] == a[:ol]:       # prefix(a) = suffix(b')
                        if ida > idb:
                            out.add((ida, idb, ol, rc, "ps"))
    return out


class TestOverlapDiscovery:
    def test_matches_naive_oracle(self, rng):
        _, reads = make_corpus(rng, 400, 60, 25)
        ix, jix, lex_f, lex_r = build_ix(reads)
        _, edges = overlap_both(ix, jix, reads, 20, lex_f, lex_r)
        got = set()
        for o in edges:
            m = o.match
            # classify by which end of the query the overlap touches
            side = "sp" if (m.coord[0].start > 0) else "ps"
            got.add((o.id[0], o.id[1], m.coord[0].length(), m.is_rc, side))
        want = naive_overlaps(reads, 20)
        assert got == want

    def test_substring_detection(self, rng):
        _, reads = make_corpus(rng, 300, 70, 35)
        reads.append(("sub0", reads[0][1][5:60]))
        ix, jix, lex_f, lex_r = build_ix(reads)
        verts, _ = overlap_both(ix, jix, reads, 20, lex_f, lex_r)
        assert [rid for rid, _, is_sub in verts if is_sub] == ["sub0"]


class TestAssembleEndToEnd:
    def test_error_free_reads_assemble_to_genome(self, rng, tmp_path):
        genome, reads = make_corpus(rng, 800, 100, 20)
        ix, jix, lex_f, lex_r = build_ix(reads)
        path = str(tmp_path / "g.asqg.gz")
        write_asqg(path, *overlap_both(ix, jix, reads, 40, lex_f, lex_r), 40)

        states = []
        for amod, vmod in ((asqg, None), (jasqg, jvis)):
            g = amod.load(path, 40)
            contain = vmod.ContainRemoveVisitor() if vmod else ContainRemoveVisitor()
            while g.has_containment:
                g.visit(contain)
            g.visit(vmod.TransitiveReductionVisitor() if vmod else TransitiveReductionVisitor())
            g.simplify()
            g.visit(vmod.TrimVisitor(150) if vmod else TrimVisitor(150))
            g.simplify()
            states.append(graph_state(g))
            if vmod is None:
                cs = contig_stats(g)
                contig = next(iter(g.vertices.values())).seq
        assert states[0] == states[1]
        assert cs["contigs"] == 1, cs
        assert contig in (genome, ab.revcomp_str(genome)), (len(contig), len(genome))


def read_contigs(path):
    contigs = {}
    with open(path) as fh:
        cid = None
        for line in fh:
            if line.startswith(">"):
                cid = line[1:].split()[0]
                contigs[cid] = ""
            else:
                contigs[cid] += line.strip()
    return contigs


class TestAsmlongCLI:
    def test_asmlong_reconstructs_genome(self, rng, tmp_path, monkeypatch):
        """asmlong CLI pipeline (StriDe/asmlong.cpp:131-226) on long
        error-free 'corrected' reads, its outputs equal to the JAX CLI's."""
        from longreadselfcorrect_tpu import cli as jcli
        from longreadselfcorrect_tpu_torch import cli

        genome, reads = make_corpus(rng, 2000, 400, 100)
        ix, jix, lex_f, lex_r = build_ix(reads)
        path = str(tmp_path / "g.asqg.gz")
        write_asqg(path, *overlap_both(ix, jix, reads, 50, lex_f, lex_r), 50)

        outs = {}
        for name, main in (("port", cli.main), ("jax", jcli.main)):
            d = tmp_path / name
            d.mkdir()
            monkeypatch.chdir(d)
            assert main(["asmlong", path, "-i", "400", "-m", "50", "-o", str(d / "out")]) == 0
            assert (d / "out-graph.asqg.gz").exists()
            assert (d / "StriDe-graph.dot").exists()
            outs[name] = [(d / "out-contigs.fa").read_text(),
                          (d / "StriDe-graph.dot").read_text(),
                          graph_state(asqg.load(str(d / "out-graph.asqg.gz"), 0))]
        assert outs["port"] == outs["jax"]
        contigs = read_contigs(tmp_path / "port" / "out-contigs.fa")
        assert len(contigs) == 1, contigs.keys()
        contig = next(iter(contigs.values()))
        assert contig in (genome, ab.revcomp_str(genome))


class TestOviewSubgraph:
    def _make_asqg(self, rng, tmp_path):
        genome, reads = make_corpus(rng, 800, 100, 20)
        ix, jix, lex_f, lex_r = build_ix(reads)
        path = str(tmp_path / "g.asqg.gz")
        write_asqg(path, *overlap_both(ix, jix, reads, 40, lex_f, lex_r), 40)
        return genome, reads, path

    def test_oview_rows_align_to_root(self, rng, tmp_path):
        from longreadselfcorrect_tpu.graph import oview as joview
        from longreadselfcorrect_tpu_torch.graph import oview
        genome, reads, path = self._make_asqg(rng, tmp_path)
        rd, omap = oview.parse_asqg(path)
        assert len(rd) == len(reads)
        root = "r5"
        out, jout = io.StringIO(), io.StringIO()
        oview.draw_alignment(out, root, rd, omap, 20, 20)
        jrd, jomap = joview.parse_asqg(path)
        joview.draw_alignment(jout, root, jrd, jomap, 20, 20)
        assert rd == jrd and out.getvalue() == jout.getvalue()
        lines = [l for l in out.getvalue().splitlines() if "ID:" in l]
        assert lines[0].endswith(f"ID:{root}")
        assert len(lines) > 1
        # error-free corpus: every overlap row reports 0 differences and the
        # clipped sequences line up with the root row column-for-column
        rootpad = lines[0].split("\t")[0]
        rstart = len(rootpad) - len(rootpad.lstrip())
        for row in lines[1:]:
            seqf, olen, nd, score = row.split("\t")[:4]
            assert nd == "0" and float(score) == 0.0
            body = seqf.strip().strip(".")
            start = len(seqf) - len(seqf.lstrip())
            for k, ch in enumerate(body):
                gpos = start + k - rstart
                if 0 <= gpos < len(rd[root]):
                    assert ch == rd[root][gpos]

    def test_subgraph_extracts_neighborhood(self, rng, tmp_path, monkeypatch):
        from longreadselfcorrect_tpu import cli as jcli
        from longreadselfcorrect_tpu_torch import cli
        genome, reads, path = self._make_asqg(rng, tmp_path)
        monkeypatch.chdir(tmp_path)
        subs = {}
        for name, main in (("port", cli.main), ("jax", jcli.main)):
            out = str(tmp_path / f"{name}.asqg.gz")
            assert main(["subgraph", "r5", path, "-s", "1", "-o", out]) == 0
            subs[name] = graph_state(asqg.load(out, 0))
        assert subs["port"] == subs["jax"]
        g = asqg.load(str(tmp_path / "port.asqg.gz"), 0)
        assert "r5" in g.vertices
        assert 1 < len(g.vertices) < len(reads)
        # span-1 neighborhood: every vertex overlaps r5 in the full graph
        full = asqg.load(path, 0)
        nbrs = {e.end.id for e in full.vertices["r5"].edges} | {"r5"}
        assert set(g.vertices) <= nbrs


class TestIslandJoin:
    """Erosion / island-collect / PE island-join visitors
    (assemble.cpp:337-360, SGVisitors.cpp:606-668,1371-1740)."""

    def _pe_setup(self, _rng=None):
        rng = np.random.default_rng(7)   # independent of fixture draw order
        genome = "".join(rng.choice(list("ACGT"), size=2000))
        # interleaved exact PE pairs: R1 = g[p:p+50], R2 = rc(g[p+100:p+150]);
        # random start positions so kmer counts vary (a uniform grid puts
        # every seed exactly at the 75th-percentile repeat cutoff)
        reads = []
        for i, p in enumerate(sorted(rng.integers(0, 1850, size=400).tolist())):
            reads.append((f"p{i}/1", genome[p : p + 50]))
            reads.append((f"p{i}/2", ab.revcomp_str(genome[p + 100 : p + 150])))
        ix, jix, lex_f, _ = build_ix(reads)
        from longreadselfcorrect_tpu.index.ssa import SampledSA as JSampledSA
        from longreadselfcorrect_tpu_torch.index.ssa import SampledSA

        return genome, reads, (ix, SampledSA(ix.bwt, lex_f)), (jix, JSampledSA(jix.bwt, lex_f))

    def test_sample_kmer_counts(self, rng):
        _, reads, (ix, _), (jix, _) = self._pe_setup(rng)
        from longreadselfcorrect_tpu_torch.graph.visitors import sample_kmer_counts

        kd = sample_kmer_counts(ix.bwt, 21, 500)
        jkd = jvis.sample_kmer_counts(jix.bwt, 21, 500)
        assert kd.total == 500
        kd.compute_attributes()
        jkd.compute_attributes()
        assert vars(kd) == vars(jkd)
        assert kd.q2 >= 1   # every sampled kmer occurs at least once

    def test_erosion_trims_bad_island_end(self, rng):
        genome, reads, (ix, _), (jix, _) = self._pe_setup(rng)
        from longreadselfcorrect_tpu_torch.graph.visitors import FastaErosionVisitor

        junk = "A" * 30  # unsupported tail
        g, jg = StringGraph(), JStringGraph()
        g.add_vertex("A", genome[100:600] + junk)
        jg.add_vertex("A", genome[100:600] + junk)
        g.visit(FastaErosionVisitor(ix.bwt, 21, 2, min_island=300))
        jg.visit(jvis.FastaErosionVisitor(jix.bwt, 21, 2, min_island=300))
        assert graph_state(g) == graph_state(jg)
        out = g.get_vertex("A").seq
        # unsupported junk tail gone; survivor is a genuine genome substring
        # (random coverage may also erode a thin prefix)
        assert out.endswith(genome[560:600])
        assert "A" * 30 not in out
        assert out in genome[100:600]

    def test_join_islands_across_gap(self, rng):
        genome, reads, (ix, ssa), (jix, jssa) = self._pe_setup(rng)
        from longreadselfcorrect_tpu_torch.graph.visitors import (
            IslandCollectVisitor, JoinIslandVisitor)

        runs = []
        for sg, vis, index, sa in ((StringGraph, None, ix, ssa), (JStringGraph, jvis, jix, jssa)):
            g = sg()
            g.add_vertex("A", genome[200:800])
            g.add_vertex("B", genome[840:1400])
            collect = (vis.IslandCollectVisitor if vis else IslandCollectVisitor)(
                index, sa, insert_size=150, kmer_size=21, island_size=300)
            g.visit(collect)
            join = (vis.JoinIslandVisitor if vis else JoinIslandVisitor)(
                100, 4000, 21, 300, collect, index, min_pe_count=2)
            g.visit(join)
            g.simplify()
            runs.append((collect, join, graph_state(g), g))
        (collect, join, state, g), (jcollect, jjoin, jstate, _) = runs
        assert (collect.island_count, join.island_count, state) == \
            (jcollect.island_count, jjoin.island_count, jstate)
        assert collect.island_count == 2
        assert collect.tslv  # read ids mapped
        assert join.island_count >= 1
        # the two islands must merge across the 40bp gap into one contig
        assert len(g.vertices) == 1
        (v,) = g.vertices.values()
        assert v.seq == genome[200:1400] or v.seq == ab.revcomp_str(
            genome[200:1400])


class TestSGSearch:
    def test_tree_walks_and_find_walks(self, rng):
        from longreadselfcorrect_tpu.graph import search as jsgs
        from longreadselfcorrect_tpu_torch.graph import search as sgs
        from longreadselfcorrect_tpu_torch.graph.core import ED_ANTISENSE, ED_SENSE

        genome, reads = make_corpus(rng, genome_len=400, read_len=80, step=40)
        ix, jix, lex_f, lex_r = build_ix(reads)
        verts, edges = overlap_both(ix, jix, reads, 40, lex_f, lex_r, irreducible=True)
        graphs = []
        for sg in (StringGraph, JStringGraph):
            g = sg()
            for rid, seq, _ in verts:
                g.add_vertex(rid, seq)
            for o in edges:
                g.add_edges_from_overlap(o)
            graphs.append(g)
        g, jg = graphs

        # the irreducible chain r0 - r1 - ... : walk from r0 along SENSE
        v0 = g.get_vertex("r0")
        dir0 = ED_SENSE if v0.count_edges(ED_SENSE) else ED_ANTISENSE
        walks = sgs.get_tree_walks(v0, dir0, 1000, 64)
        jwalks = jsgs.get_tree_walks(jg.get_vertex("r0"), dir0, 1000, 64)
        assert [w.get_string() for w in walks] == [w.get_string() for w in jwalks]
        assert walks
        longest = max(walks, key=lambda w: len(w.edges))
        s = longest.get_string()
        # the walk string reconstructs a genome substring (either strand)
        assert s in genome or ab.revcomp_str(s) in genome
        assert len(s) > len(v0.seq)

        # find_walks between r0 and the last vertex of the longest walk
        target = longest.last_vertex()
        found, complete = sgs.find_walks(v0, target, dir0, 1000, 64)
        jfound, jcomplete = jsgs.find_walks(jg.get_vertex("r0"), jg.get_vertex(target.id),
                                            dir0, 1000, 64)
        assert ([w.get_string() for w in found], complete) == \
            ([w.get_string() for w in jfound], jcomplete)
        assert complete and found
        assert any(w.get_string() == s for w in found)
