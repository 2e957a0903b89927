"""Three inputs on which the port's device engine once differed from the
host engine or stopped: lowercase reads, a batch of only empty reads, and
reads shorter than the seed table's depth (the host engine's k-mer table
raised for 19-50 bp).

The corpus is tests/test_torch_correct.py's (a 9 kb genome at 30x of
exact 1 kb reads); the device engine runs its plain versions on the CPU.
Outputs are compared byte for byte, counters exactly.
"""
import os

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu import cli as jcli
from longreadselfcorrect_tpu_torch import cli
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams, SelfCorrector
from longreadselfcorrect_tpu_torch.io import fasta

from test_batch_correct import noisy_reads   # 1.2 kb reads, sub/del/ins
from test_torch_correct import COUNTERS, assert_same_as_host, corpus, corrector  # noqa: F401

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

EMPTY = [("e0", ""), ("e1", "")]


def reads450(genome, seed, n):
    """n noisy reads at 6% error, cut to their first 450 bp (the plain walks
    on the CPU take seconds a read)."""
    return [(rid, seq[:450]) for rid, seq in noisy_reads(genome, np.random.default_rng(seed), n, 0.06)]


def write_reads(path, items):
    with open(path, "w") as fh:
        for rid, seq in items:
            fasta.write_fasta(fh, rid, seq)


def same_files(a, b, names=("correct.fa", "discard.fa")):
    for name in names:
        with open(os.path.join(a, name), "rb") as x, open(os.path.join(b, name), "rb") as y:
            assert x.read() == y.read(), name


def soft_masked(items):
    """The first read lowercased, the second with its middle third
    lowercased (soft-masked)."""
    out = []
    for i, (rid, seq) in enumerate(items):
        if i == 0:
            seq = seq.lower()
        elif i == 1:
            a, b = len(seq) // 3, 2 * len(seq) // 3
            seq = seq[:a] + seq[a:b].lower() + seq[b:]
        out.append((rid, seq))
    return out


def test_lowercase_cli_matches_jax_host_cli(corpus):
    """pbcorrect on a FASTA with lowercase and soft-masked reads: the
    port's device engine writes the JAX host CLI's correct.fa and
    discard.fa, byte for byte (the seeds come from rank space, upper
    case, on both engines)."""
    genome, prefix, _, _, _, d = corpus
    reads_fa = str(d / "lower.fa")
    write_reads(reads_fa, soft_masked(reads450(genome, 23, 2)))
    common = [reads_fa, "-p", prefix, "-c", "30"]
    out_port, out_jax = str(d / "lower_port"), str(d / "lower_jax")
    assert cli.main(["pbcorrect", *common, "-o", out_port, "--device", "cpu"]) == 0
    assert jcli.main(["pbcorrect", *common, "-o", out_jax, "--engine", "host"]) == 0
    same_files(out_port, out_jax)
    with open(os.path.join(out_port, "correct.fa")) as fh:
        text = fh.read()
    assert text.count(">") == 2
    body = "".join(line for line in text.splitlines() if not line.startswith(">"))
    assert body == body.upper()


@pytest.mark.parametrize("prefetch", ["all", "half"])
def test_lowercase_read_prefetch_as_upper(corpus, monkeypatch, prefetch):
    """A lowercased read takes the prefetch hits and misses, and gives the
    results, of the same read upper case.  With prefetch "half" every other
    enumerated gap is left out of the first device round, so the replay
    takes the miss path (a pretended walk result, the read replayed after
    the next round) on both."""
    genome, _, hix, dix, jhix, _ = corpus
    if prefetch == "half":
        enumerate_walks = BatchedSelfCorrector._enumerate_walks

        def every_other(self, per_read):
            tasks, keys = enumerate_walks(self, per_read)
            return tasks[::2], keys[::2]

        monkeypatch.setattr(BatchedSelfCorrector, "_enumerate_walks", every_other)
    items = reads450(genome, 7, 1)
    runs = []
    for seqs in (items, [(rid, seq.lower()) for rid, seq in items]):
        port = corrector(hix, dix)
        runs.append((port.process_batch(seqs), port.stats))
    (upper, st_u), (lower, st_l) = runs
    for name in ("prefetch_hit", "prefetch_miss", "host_fallback"):
        assert st_l[name] == st_u[name], (name, st_l, st_u)
    assert st_u["prefetch_hit"] > 0
    assert (st_u["prefetch_miss"] > 0) == (prefetch == "half")
    for a, b in zip(upper, lower):
        for name in COUNTERS:
            assert getattr(a, name) == getattr(b, name), name
    assert_same_as_host(jhix, items, lower)


@pytest.mark.parametrize("where", ["last", "only"])
def test_all_empty_batch_matches_host(corpus, where):
    """process_stream whose last batch, or whose only batch, holds only
    empty records: every result equals the host SelfCorrector's (the
    reads are not merged, so the CLI writes them to discard.fa)."""
    genome, _, hix, dix, jhix, _ = corpus
    reads = reads450(genome, 31, 1)
    batches = [reads, EMPTY] if where == "last" else [EMPTY]
    port = corrector(hix, dix)
    got = [r for part in port.process_stream(batches) for r in part]
    items = [it for b in batches for it in b]
    assert len(got) == len(items)
    assert_same_as_host(jhix, items, got)
    assert [r.merge for r in got[-2:]] == [False, False]


def test_all_empty_batch_cli_discard_matches_jax_host_cli(corpus):
    """The CLI over a FASTA of a read and two empty records, whose last
    batch (--batch-reads 2) holds only an empty record: correct.fa and
    discard.fa equal the JAX host CLI's."""
    genome, prefix, _, _, _, d = corpus
    reads_fa = str(d / "empty_tail.fa")
    write_reads(reads_fa, reads450(genome, 37, 1) + EMPTY)
    common = [reads_fa, "-p", prefix, "-c", "30"]
    out_port, out_jax = str(d / "empty_port"), str(d / "empty_jax")
    assert cli.main(["pbcorrect", *common, "-o", out_port, "--device", "cpu",
                     "--batch-reads", "2"]) == 0
    assert jcli.main(["pbcorrect", *common, "-o", out_jax, "--engine", "host"]) == 0
    same_files(out_port, out_jax)
    with open(os.path.join(out_port, "discard.fa")) as fh:
        assert fh.read().endswith(">e0\n\n>e1\n\n")


def test_short_reads_host_equals_device(corpus):
    """Reads of every length from 15 to 52 bp cut from the genome at 8%
    error: the port's host engine (whose k-mer table once raised below 51
    bp) equals its device engine, counter for counter."""
    genome, _, hix, dix, _, _ = corpus
    rng = np.random.default_rng(41)
    items = []
    for n in range(15, 53):
        p = int(rng.integers(0, len(genome) - 1300))
        seq = noisy_reads(genome[p : p + 1300], rng, 1, 0.08)[0][1][:n]
        items.append((f"s{n}", seq))
    assert [len(s) for _, s in items] == list(range(15, 53))
    port = corrector(hix, dix)
    got = port.process_batch(items)
    host = SelfCorrector(hix, CorrectionParams(pb_coverage=30, genome=10))
    seeded = 0
    for (rid, seq), res in zip(items, got):
        want = host.process(rid, seq)
        for name in COUNTERS:
            assert getattr(res, name) == getattr(want, name), (rid, name)
        seeded += want.total_seed_num > 0
    assert seeded > 0
