"""The port's pbcorrect equals the JAX package's host SelfCorrector on
streamed batches and on a gap beyond every device config.

As test_torch_correct.py, whose corpus and helpers this file shares: the
port's BatchedSelfCorrector walks through the plain device versions on the
CPU; corrected strings, merge flags and counters are compared exactly.
These mirror tests/test_batch_correct.py's test_stream_matches_batch and
test_planted_giant_gap_matches_host.
"""
import numpy as np
import torch

from test_batch_correct import noisy_reads   # 1.2 kb reads, sub/del/ins
from test_torch_correct import COUNTERS, assert_same_as_host, corpus, corrector  # noqa: F401

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def test_stream_matches_batch_and_host(corpus):
    """tests/test_batch_correct.py::test_stream_matches_batch: 8 reads in
    three stream batches equal one process_batch and the host."""
    genome, _, hix, dix, jhix, _ = corpus
    items = noisy_reads(genome, np.random.default_rng(21), 8, 0.06)
    port = corrector(hix, dix)
    whole = port.process_batch(items)
    streamed = [r for part in port.process_stream([items[:3], items[3:6], items[6:]])
                for r in part]
    assert len(streamed) == len(whole)
    for a, b in zip(whole, streamed):
        for name in COUNTERS:
            assert getattr(a, name) == getattr(b, name), name
    assert_same_as_host(jhix, items, streamed)


def test_planted_giant_gap_matches_host(corpus):
    """tests/test_batch_correct.py::test_planted_giant_gap_matches_host: a
    read whose seeds flank a 3.5 kb gap of random sequence, beyond every
    device config: routed to the host engine or the raw fallback."""
    genome, _, hix, dix, jhix, _ = corpus
    g2 = np.random.default_rng(33)
    middle = "".join(g2.choice(list("ACGT"), size=3500))
    items = [("giant", genome[100:700] + middle + genome[5000:5600])]
    port = corrector(hix, dix)
    got = port.process_batch(items)
    assert_same_as_host(jhix, items, got)
