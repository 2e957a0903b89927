"""The traffic generator: a stream of distinct reads drawn from the seed,
each batch spanning the lengths; the warm-up's reads fixed and left out."""
import numpy as np

from pbbench import traffic

LENGTHS = np.random.default_rng(0).integers(100, 20_000, size=5000)
SHORT = {"max_len": 1499, "order": "shuffle", "batch_reads": 64}


def test_stream_takes_each_read_once_from_the_seed():
    sel = traffic.selection(SHORT, LENGTHS)
    skip = traffic.warm(SHORT, LENGTHS, 2)
    a = traffic.stream(SHORT, LENGTHS, np.random.default_rng(1), skip=skip)
    b = traffic.stream(SHORT, LENGTHS, np.random.default_rng(2), skip=skip)
    assert sorted(a.tolist()) == sorted(set(sel.tolist()) - set(skip.tolist()))
    assert sorted(b.tolist()) == sorted(a.tolist())
    # different seeds, different reads in the first batches; one seed, one stream
    assert set(a[:64].tolist()) != set(b[:64].tolist())
    assert np.array_equal(a, traffic.stream(SHORT, LENGTHS, np.random.default_rng(1), skip=skip))


def test_shuffled_batches_span_the_lengths():
    """Each full batch takes one read of each of batch_reads length strata,
    so every seed's batches carry the same spread of lengths."""
    sel = traffic.selection(SHORT, LENGTHS)
    by_len = sel[np.argsort(LENGTHS[sel], kind="stable")]
    stratum = {int(r): k for k, s in enumerate(np.array_split(by_len, 64)) for r in s}
    ids = traffic.stream(SHORT, LENGTHS, np.random.default_rng(3))
    full = [b for b in traffic.batches(ids, 64) if len(b) == 64]
    assert len(full) == len(sel) // 64
    for b in full:
        assert sorted(stratum[int(r)] for r in b) == list(range(64))
    sums = [int(LENGTHS[b].sum()) for b in full]
    assert max(sums) - min(sums) < 0.05 * np.mean(sums)


def test_warm_reads_are_fixed_near_the_median():
    w = traffic.warm(SHORT, LENGTHS, 2)
    sel = traffic.selection(SHORT, LENGTHS)
    assert len(w) == 2 and set(w.tolist()) <= set(sel.tolist())
    assert np.array_equal(w, traffic.warm(SHORT, LENGTHS, 2))
    med = np.median(LENGTHS[sel])
    assert np.all(np.abs(LENGTHS[w] - med) <= np.sort(np.abs(LENGTHS[sel] - med))[1])


def test_longest_first():
    mix = {"min_len": 6000, "order": "longest_first", "batch_reads": 64}
    p = traffic.stream(mix, LENGTHS, np.random.default_rng(3))
    assert len(p) == int((LENGTHS >= 6000).sum())
    assert np.all(np.diff(LENGTHS[p]) <= 0)
    assert [len(b) for b in traffic.batches(p, 64)][:-1] == [64] * (len(p) // 64)
