"""The read simulator: lengths, error rate and the 10:60:30 mix, and each
kind of error made as stated."""
import numpy as np
import pytest

from pbbench import simreads

CLR = {"length_mean": 3000, "length_sd": 2300, "length_min": 100, "length_max": 25000,
       "accuracy_mean": 0.85, "accuracy_sd": 0.02, "accuracy_min": 0.75,
       "accuracy_max": 0.90, "error_ratio_sub_ins_del": [10, 60, 30]}


def test_lengths():
    lens = simreads.read_lengths(np.random.default_rng(1), CLR, 60_000_000)
    assert 60_000_000 <= lens.sum() < 60_000_000 + 25_000
    assert lens.min() >= 100 and lens.max() <= 25_000
    # the cut at 25 kb takes a little off the log-normal's mean and s.d.
    assert abs(lens.mean() - 3000) / 3000 < 0.03
    assert abs(lens.std() - 2300) / 2300 < 0.06


def test_error_rate_and_mix():
    rng = np.random.default_rng(2)
    g = simreads.genome(rng, 1_000_000)
    bases, offsets, ev = simreads.clr_reads(rng, g, CLR, 10)
    errors = ev["substitutions"] + ev["insertions"] + ev["deletions"]
    assert abs(errors / ev["template_bases"] - 0.15) < 0.005
    mix = np.array([ev["substitutions"], ev["insertions"], ev["deletions"]]) / errors
    assert np.allclose(mix, [0.1, 0.6, 0.3], atol=0.01)
    # read lengths as drawn: the template is shortened for the net insertions
    assert abs(np.diff(offsets).mean() - 3000) / 3000 < 0.05
    assert offsets[-1] == len(bases) and abs(len(bases) / 10_000_000 - 1) < 0.01


def revcomp(a):
    return (3 - a)[::-1]


def find(g, read):
    """Whether read is a substring of g or of its reverse complement."""
    s, r = g.tobytes(), read.tobytes()
    return r in s or revcomp(read).tobytes() in s


@pytest.mark.parametrize("ratio", [[1, 0, 0], [0, 1, 0], [0, 0, 1]])
def test_each_kind(ratio):
    rng = np.random.default_rng(3)
    g = simreads.genome(rng, 5000)
    model = {**CLR, "length_mean": 300, "length_sd": 50, "length_max": 600,
             "error_ratio_sub_ins_del": ratio}
    bases, offsets, ev = simreads.clr_reads(rng, g, model, 5)
    kind = ("substitutions", "insertions", "deletions")[ratio.index(1)]
    assert ev[kind] > 0 and sum(ev[k] for k in ("substitutions", "insertions", "deletions")) == ev[kind]
    n = len(offsets) - 1
    if kind == "insertions":
        assert len(bases) == ev["template_bases"] + ev["insertions"]
    elif kind == "deletions":
        assert len(bases) == ev["template_bases"] - ev["deletions"]
    else:
        assert len(bases) == ev["template_bases"]
        # a substitution changes the base: each read differs from its
        # template in as many places as it has substitutions
        assert sum(not find(g, bases[offsets[i]:offsets[i + 1]]) for i in range(n)) > 0


def test_exact_reads_are_genome_pieces():
    rng = np.random.default_rng(4)
    g = simreads.genome(rng, 5000)
    model = {**CLR, "length_mean": 300, "length_sd": 50, "length_max": 600,
             "accuracy_mean": 1.0, "accuracy_sd": 0.0, "accuracy_min": 1.0, "accuracy_max": 1.0}
    bases, offsets, ev = simreads.clr_reads(rng, g, model, 3)
    n = len(offsets) - 1
    assert ev["substitutions"] == ev["insertions"] == ev["deletions"] == 0
    assert all(find(g, bases[offsets[i]:offsets[i + 1]]) for i in range(n))
    strands = [bases[offsets[i]:offsets[i + 1]].tobytes() in g.tobytes() for i in range(n)]
    assert 0.3 < np.mean(strands) < 0.7
