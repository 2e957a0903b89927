"""The port's pbcorrect takes every flag of the JAX package's pbcorrect:
--onlyseed with -b (seeds scored against a barcode file) on both engines,
byte-equal to the JAX CLI; --onlyseed without -b refused; --debugextend
accepted and writing nothing; --walk-config reaching the device engine.

The corpus is tests/test_torch_correct.py's (a 9 kb genome at 30x of
exact 1 kb reads); the device engine runs its plain versions on the CPU.
"""
import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu import cli as jcli
from longreadselfcorrect_tpu_torch import cli
from longreadselfcorrect_tpu_torch.core import batch_correct
from longreadselfcorrect_tpu_torch.io import fasta

from chip_smoke import barcoded_reads
from test_torch_correct import corpus  # noqa: F401

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def barcoded(corpus):
    genome, prefix, _, _, _, d = corpus
    reads, records = barcoded_reads(genome, np.random.default_rng(55), 8, 1000, 0.04)
    reads_fa, barcode = str(d / "barcoded.fa"), str(d / "barcoded.bcode")
    with open(reads_fa, "w") as fh:
        for rid, seq in reads:
            fasta.write_fasta(fh, rid, seq)
    with open(barcode, "w") as fh:
        fh.write("\n".join(records) + "\n")
    return prefix, d, reads_fa, barcode


def run(main, argv):
    """(return code, stdout) of a CLI's main."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("engine", ["host", "device"])
def test_onlyseed_matches_jax_cli(barcoded, engine):
    """total.seed, the TOTAL line and the seed dumps (--onlyseed sets
    --debugseed) equal the JAX CLI's; the device engine scores the seeds of
    its own seed phase."""
    prefix, d, reads_fa, barcode = barcoded
    common = [reads_fa, "-p", prefix, "-c", "30", "--onlyseed", "-b", barcode]
    out_port, out_jax = str(d / f"onlyseed_{engine}"), str(d / f"onlyseed_jax_{engine}")
    extra = ["--engine", engine] + (["--device", "cpu"] if engine == "device" else [])
    rc_p, stdout_p = run(cli.main, ["pbcorrect", *common, "-o", out_port, *extra])
    rc_j, stdout_j = run(jcli.main, ["pbcorrect", *common, "-o", out_jax])
    assert rc_p == rc_j == 0
    assert stdout_p == stdout_j and stdout_p.startswith("TOTAL [")
    port, jax = tree(out_port), tree(out_jax)
    assert port == jax
    assert port["total.seed"].count(b"\n") >= 2
    assert sum(p.startswith("seed/") for p in port) >= 8


def test_onlyseed_without_barcode_refused(barcoded, capsys):
    prefix, d, reads_fa, _ = barcoded
    assert cli.main(["pbcorrect", reads_fa, "-p", prefix, "-o", str(d / "nobc"),
                     "--onlyseed", "--device", "cpu"]) == 1
    assert "pbcorrect --onlyseed requires -b/--barcode" in capsys.readouterr().err
    assert not os.path.exists(d / "nobc" / "total.seed")


def test_debugextend_and_walk_config(barcoded, monkeypatch):
    """--walk-config G,MAXLEN,QMAX,WSCAN sets the device engine's walk
    config; --debugextend changes no output file and adds none."""
    prefix, d, reads_fa, _ = barcoded
    one = str(d / "one.fa")
    rec = list(fasta.read_seqs(reads_fa))[0]
    with open(one, "w") as fh:
        fasta.write_fasta(fh, rec.id, rec.seq[:400])
    made = []
    orig = batch_correct.BatchedSelfCorrector.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(batch_correct.BatchedSelfCorrector, "__init__", init)
    outs = []
    for flags in ([], ["--debugextend"]):
        out = str(d / f"extend{len(flags)}")
        rc, stdout = run(cli.main, ["pbcorrect", one, "-p", prefix, "-c", "30", "-o", out,
                                    "--device", "cpu", "--walk-config", "48,600,560,288",
                                    *flags])
        assert rc == 0
        outs.append((tree(out), stdout))
    assert outs[0][0] == outs[1][0] and set(outs[0][0]) == {
        "correct.fa", "discard.fa", "threshold-table"}
    assert outs[0][1] == outs[1][1]
    assert len(made) == 2
    for c in made:
        assert (c.cfg.G, c.cfg.MAXLEN, c.cfg.QMAX, c.cfg.WSCAN) == (48, 600, 560, 288)


def options(main) -> set[str]:
    """The option strings of a CLI's pbcorrect, from its --help."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["pbcorrect", "--help"])
    return set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w-]*)", buf.getvalue()))


def test_takes_every_jax_pbcorrect_flag():
    jax_flags, port_flags = options(jcli.main), options(cli.main)
    assert {"--onlyseed", "-b", "--barcode", "--debugextend", "--walk-config",
            "--num-processes", "--process-id", "--coordinator"} <= jax_flags
    assert jax_flags <= port_flags, jax_flags - port_flags
