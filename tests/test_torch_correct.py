"""The port's pbcorrect equals the JAX package's host SelfCorrector.

The port's BatchedSelfCorrector runs the seed phase and the walks through
the plain device versions on the CPU (prefetch, miss rounds, host-engine
fallback).  Corrected strings, merge flags and counters are compared with
exact equality, and the CLI's correct.fa byte for byte.  These mirror the
JAX package's tests/test_batch_correct.py end-to-end tests.
"""
import os

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu import cli as jcli
from longreadselfcorrect_tpu.core.correct import CorrectionParams as JParams
from longreadselfcorrect_tpu.core.correct import SelfCorrector as JSelfCorrector
from longreadselfcorrect_tpu.index.host import HostFM as JHostFM
from longreadselfcorrect_tpu.index.host import HostIndexSet as JHostIndexSet
from longreadselfcorrect_tpu_torch import cli
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.io import fasta
from longreadselfcorrect_tpu_torch.ops import walk

from test_batch_correct import noisy_reads   # 1.2 kb reads, sub/del/ins

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

COUNTERS = ("merge", "corrected_strs", "total_reads_len", "corrected_len",
            "total_seed_num", "total_walk_num", "high_error_num",
            "exceed_depth_num", "exceed_leave_num", "fm_num", "dp_num", "seed_dis")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_batch_correct.py's corpus (seed 99: 9 kb genome, 270
    exact 1 kb reads, both strands), indexed once through the port's CLI."""
    rng = np.random.default_rng(99)
    genome = "".join(rng.choice(list("ACGT"), size=9000))
    d = tmp_path_factory.mktemp("correct")
    reads_fa = str(d / "reads.fa")
    with open(reads_fa, "w") as fh:
        for i in range(270):
            p = rng.integers(0, len(genome) - 1000)
            r = genome[p : p + 1000]
            fasta.write_fasta(fh, f"c{i}", ab.revcomp_str(r) if i % 2 else r)
    prefix = str(d / "reads")
    assert cli.main(["index", reads_fa, "-p", prefix, "--pure-python"]) == 0
    hix, dix = open_index(prefix, device="cpu")
    jhix = JHostIndexSet(JHostFM(hix.bwt.symbols, hix.bwt.num_strings),
                         JHostFM(hix.rbwt.symbols, hix.rbwt.num_strings))
    return genome, prefix, hix, dix, jhix, d


def corrector(hix, dix):
    return BatchedSelfCorrector(
        hix, dix, CorrectionParams(pb_coverage=30, genome=10),
        cfg=walk.WalkConfig(G=64, MAXLEN=640, QMAX=640, WSCAN=320))


def assert_same_as_host(jhix, items, got):
    host = JSelfCorrector(jhix, JParams(pb_coverage=30, genome=10))
    n_fm = 0
    for (rid, seq), res in zip(items, got):
        want = host.process(rid, seq)
        for name in COUNTERS:
            assert getattr(res, name) == getattr(want, name), (rid, name)
        n_fm += want.fm_num
    return n_fm


def test_process_batch_matches_jax_host(corpus):
    """tests/test_batch_correct.py::test_batched_matches_host: 6 reads,
    every counter equal, and the prefetch serves nearly every gap."""
    genome, _, hix, dix, jhix, _ = corpus
    items = noisy_reads(genome, np.random.default_rng(7), 6, 0.06)
    port = corrector(hix, dix)
    got = port.process_batch(items)
    n_fm = assert_same_as_host(jhix, items, got)
    assert n_fm > 0 and all(r.merge for r in got)
    assert set(port.phase_times) == {"seed", "walks", "replay", "replay.host_engine",
                                     "replay.dp", "replay.rounds"}
    assert port.phase_times["walks"] > 0
    st = port.stats
    total = st["prefetch_hit"] + st["prefetch_miss"] + st["host_fallback"]
    assert total > 0 and st["prefetch_hit"] >= 0.8 * total, st
    assert st["host_fallback"] == st["fb_unfit"] + st["fb_flagged"] + st["fb_lastround"]
    assert st["gaps"] > 0


def test_cli_correct_fa_matches_jax_host_cli(corpus):
    genome, prefix, _, _, _, d = corpus
    reads_fa = str(d / "noisy.fa")
    with open(reads_fa, "w") as fh:
        for rid, seq in noisy_reads(genome, np.random.default_rng(21), 1, 0.06):
            fasta.write_fasta(fh, rid, seq)
        fasta.write_fasta(fh, "too_short", "ACGTACGTAC")   # lands in discard.fa
    common = [reads_fa, "-p", prefix, "-c", "30"]
    out_port, out_jax = str(d / "port"), str(d / "jax")
    assert cli.main(["pbcorrect", *common, "-o", out_port, "--device", "cpu"]) == 0
    assert jcli.main(["pbcorrect", *common, "-o", out_jax, "--engine", "host"]) == 0
    for name in ("correct.fa", "discard.fa", "threshold-table"):
        with open(os.path.join(out_port, name), "rb") as a, \
                open(os.path.join(out_jax, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(out_port, "correct.fa")) as fh:
        assert fh.read().count(">") == 1
