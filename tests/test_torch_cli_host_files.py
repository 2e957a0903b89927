"""Files written by one package's CLI are read by the other's.

Index files (`index`: .bwt.npz/.rbwt.npz/.lex/.rlex/.ssa/.rssa) and ASQG
graphs (`overlap`) written by the JAX CLI go into the port's readers, and
the port's into the JAX ones; each reader's outputs equal the writer's own
reader on the same files.  Every run is a subprocess with PYTHONHASHSEED=0
in a directory of its own holding copies of the files it reads.
"""
import os
import shutil
import threading

import pytest

import chip_smoke as cs
from longreadselfcorrect_tpu_torch.core.alphabet import revcomp_str
from longreadselfcorrect_tpu_torch.io import fasta

CLI = {"jax": "longreadselfcorrect_tpu.cli", "port": "longreadselfcorrect_tpu_torch.cli"}
INPUTS = ("sr.fa", "pb.fa", "asm.fa", "sub.fa", "pb2.fa", "grep.txt", "kmerfreq.txt")
ASQG = "asm.asqg.gz"

# (reader, argv, stdin, outputs, written files it reads) in a run directory
# holding the inputs and the writer's files; "sr"/"pb"/"asm" are the
# writer's index prefixes of sr.fa/pb.fa/asm.fa, asm.asqg.gz its overlap
READERS = {
    "correct": (["correct", "-p", "sr", "-o", "out.fa", "--discard", "bad.fa", "sub.fa"],
                None, ["out.fa", "bad.fa"], ["sr"]),
    "pbhc": (["pbhc", "pb2.fa", "-p", "sr", "-f", "pb", "-o", "out.fa", "-r", "100",
              "-c", "60"], None, ["out.fa", "out.discard.fa", cs.STDOUT], ["sr", "pb"]),
    "fmwalk": (["fmwalk", "-a", "validate", "-p", "sr", "-m", "31", "--discard", "",
                "-o", "out.fa", "sub.fa"], None, ["out.fa"], ["sr"]),
    "filter": (["filter", "-p", "pb", "--no-kmer-check", "-o", "out.fa", "pb.fa"],
               None, ["out.fa", "out.fa.discard.fa"], ["pb"]),
    "merge": (["merge", "asm.fa", "-p", "asm", "-m", "50", "-o", "out.fa"],
              None, ["out.fa"], ["asm"]),
    "grep": (["grep", "sr.fa", "-p", "sr"], "grep.txt", [cs.STDOUT], ["sr"]),
    "kmerfreq": (["kmerfreq", "-p", "sr", "-c", "60"], "kmerfreq.txt", [cs.STDOUT], ["sr"]),
    "asmlong": (["asmlong", ASQG, "-i", "400", "-m", "50", "-o", "out"], None,
                ["out-contigs.fa", "out-graph.asqg.gz", "StriDe-graph.dot"], [ASQG]),
    "assemble": (["assemble", ASQG, "-m", "50", "-r", "400", "-i", "400", "--no-pe",
                  "-o", "out"], None, ["out-contigs.fa"], [ASQG]),
    "oview": (["oview", ASQG], None, [cs.STDOUT], [ASQG]),
    "subgraph": (["subgraph", "r5", ASQG, "-s", "1", "-o", "sub.asqg.gz"], None,
                 ["sub.asqg.gz", "sub.asqg.gz.dot"], [ASQG]),
}


def in_parallel(fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def run_ok(module, d, stage):
    argv, rc, out, err, _ = cs.run_host_stage(module, d, stage)
    assert rc == 0, (module, argv, err[-3000:])
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Phase 16's corpus, plus error-free 400 bp reads every 100 bp over
    its first 2 kb (asm.fa), the first 100 short reads (sub.fa) and the
    first 2 long reads (pb2.fa); then each package's index of sr.fa, pb.fa
    and asm.fa and its overlap of asm.fa, in a directory per package."""
    base = tmp_path_factory.mktemp("files")
    src = base / "in"
    src.mkdir()
    genome = cs.make_host_corpus(str(src))
    with open(src / "asm.fa", "w") as f:
        for i, p in enumerate(range(0, 1601, 100)):
            r = genome[p : p + 400]
            f.write(f">r{i}\n{revcomp_str(r) if i % 3 == 1 else r}\n")
    for name, whole, n in (("sub.fa", "sr.fa", 100), ("pb2.fa", "pb.fa", 2)):
        recs = list(fasta.read_seqs(str(src / whole)))[:n]
        with open(src / name, "w") as f:
            f.writelines(f">{r.id}\n{r.seq}\n" for r in recs)

    def write(pkg):
        d = base / pkg
        d.mkdir()
        for name in INPUTS:
            shutil.copy(src / name, d / name)
        for reads in ("sr.fa", "pb.fa", "asm.fa"):
            run_ok(CLI[pkg], str(d), ("index", ["index", reads], None, []))
        run_ok(CLI[pkg], str(d), ("overlap", ["overlap", "-p", "asm", "-m", "50", "-o", ASQG,
                                              "asm.fa"], None, []))
        return d

    dirs = dict(zip(CLI, in_parallel([lambda: write("jax"), lambda: write("port")])))
    yield dirs
    shutil.rmtree(base, ignore_errors=True)


def test_writers_agree(written):
    """Both packages wrote the same index files and the same graph."""
    for prefix in ("sr", "pb", "asm"):
        for suffix in cs.INDEX_FILES:
            assert cs.output_bytes(str(written["port"]), prefix + suffix) == \
                cs.output_bytes(str(written["jax"]), prefix + suffix), prefix + suffix
    assert cs.output_bytes(str(written["port"]), ASQG) == \
        cs.output_bytes(str(written["jax"]), ASQG)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("sub", sorted(READERS))
def test_reader_of_the_other_package(written, tmp_path, sub, writer):
    argv, stdin, outputs, reads = READERS[sub]
    reader = "port" if writer == "jax" else "jax"
    src = written[writer]
    runs = {}
    for pkg in (writer, reader):
        d = tmp_path / pkg
        d.mkdir()
        for name in INPUTS:
            shutil.copy(src / name, d / name)
        for name in reads:
            for f in ([name] if name == ASQG else [name + s for s in cs.INDEX_FILES]):
                shutil.copy(src / f, d / f)
        runs[pkg] = str(d)
    outs = in_parallel([lambda pkg=pkg: run_ok(CLI[pkg], runs[pkg], (sub, argv, stdin, outputs))
                        for pkg in (writer, reader)])
    assert outs[0] == outs[1]
    for name in outputs:
        if name != cs.STDOUT:
            assert cs.output_bytes(runs[reader], name) == cs.output_bytes(runs[writer], name), name
