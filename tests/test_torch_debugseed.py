"""pbcorrect --debugseed writes the same files with either engine.

The host engine writes four per-read dumps: seed/<read>.seed (the seeds),
extend/<read>.log (the attribute ratio trace of get_seq_attribute),
seed/error/<read>.seed (the hitchhiked outcasts) and extend/<read>.ext /
.dp (the failed gaps).  The device engine, here on the CPU through the
plain versions, must write every one of them byte for byte, as well as
correct.fa, discard.fa and the threshold table.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu_torch import cli
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.io import fasta
from longreadselfcorrect_tpu_torch.ops import walk

torch.set_num_threads(1)


def noisify(rng, s, e):
    out = []
    for ch in s:
        r = rng.random()
        if r < e * 0.6:
            out.append("ACGT"[("ACGT".index(ch) + int(rng.integers(1, 4))) % 4])
        elif r < e * 0.8:
            pass
        elif r < e:
            out += [ch, "ACGT"[int(rng.integers(0, 4))]]
        else:
            out.append(ch)
    return "".join(out)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 3 kb genome at 20x (60 exact 1 kb reads, both strands) and two
    120 bp units in 120 and 60 reads of their own; three queries: two
    stretches of the genome at 8% error and one that carries A + B + A at
    3%, where A's repeat seeds hitchhike B's (freq ratio 60/120 < 0.6)."""
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    unit_a, unit_b = ("".join(rng.choice(list("ACGT"), size=120)) for _ in range(2))
    d = tmp_path_factory.mktemp("debugseed")
    reads_fa = str(d / "reads.fa")
    with open(reads_fa, "w") as fh:
        for i in range(60):
            p = rng.integers(0, len(genome) - 1000)
            r = genome[p : p + 1000]
            fasta.write_fasta(fh, f"c{i}", ab.revcomp_str(r) if i % 2 else r)
        for unit, copies, tag in ((unit_a, 120, "a"), (unit_b, 60, "b")):
            for i in range(copies):
                flank = ["".join(rng.choice(list("ACGT"), size=25)) for _ in range(2)]
                r = flank[0] + unit + flank[1]
                fasta.write_fasta(fh, f"{tag}{i}", ab.revcomp_str(r) if i % 2 else r)
    queries = str(d / "queries.fa")
    with open(queries, "w") as fh:
        for i, p in enumerate((700, 1500)):
            fasta.write_fasta(fh, f"q{i}", noisify(rng, genome[p : p + 900], 0.08))
        fasta.write_fasta(fh, "q2", noisify(
            rng, genome[400:800] + unit_a + unit_b + unit_a + genome[800:1200], 0.03))
    prefix = str(d / "reads")
    assert cli.main(["index", reads_fa, "-p", prefix, "--pure-python"]) == 0
    return d, prefix, queries


def tree(root):
    return sorted(os.path.relpath(os.path.join(a, f), root)
                  for a, _, files in os.walk(root) for f in files)


def test_debugseed_engines_write_equal_dirs(corpus):
    d, prefix, queries = corpus
    outs = {}
    for engine in (["--engine", "host"], ["--engine", "device", "--device", "cpu"]):
        out = str(d / f"out_{engine[1]}")
        assert cli.main(["pbcorrect", queries, "-p", prefix, "-o", out, "-c", "30",
                         "--debugseed", *engine]) == 0
        outs[engine[1]] = out
    host, dev = outs["host"], outs["device"]
    files = tree(host)
    assert tree(dev) == files
    for q in ("q0", "q1", "q2"):
        for f in (f"seed/{q}.seed", f"seed/error/{q}.seed", f"extend/{q}.log",
                  f"extend/{q}.ext", f"extend/{q}.dp"):
            assert f in files, f
    for f in files:
        assert filecmp.cmp(os.path.join(host, f), os.path.join(dev, f), shallow=False), f
    assert os.path.getsize(os.path.join(host, "seed/error/q2.seed")) > 0
    assert os.path.getsize(os.path.join(host, "extend/q0.log")) > 0


def test_debugseed_off_reads_back_no_scan_row(corpus):
    """Without --debugseed the device seed records are the ten of the main
    path: the scan-k freq row stays on the device."""
    _, prefix, queries = corpus
    hix, dix = open_index(prefix, device="cpu")
    wx = walk.WalkIndex.build(dix, hix, ck=walk.walk_ck(hix.bwt.n))
    items = [(r.id, r.seq) for r in fasta.read_seqs(queries)]
    c = BatchedSelfCorrector(hix, wx, CorrectionParams(pb_coverage=30))
    (_, _, records), = c._seed_submit(items)
    assert len(records) == 10
