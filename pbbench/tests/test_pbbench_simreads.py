"""The read simulator: lengths, error rate and the 10:60:30 mix, and each
kind of error made as stated; the genome's planted repeat families."""
import hashlib
import json
import os

import numpy as np
import pytest

from pbbench import corpus, simreads

from conftest import ROOT, TINY

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


# the data set of TINY and the stamps of the configurations as they were
# before repeat families existed: a genome without them draws nothing more
TINY_SHA256 = {"bases.npy": "2eee8083c2348b835867e577807d44d5e72e8f84d49f5feb84e6dd5356e64393",
               "offsets.npy": "b8246bd3fce71c3a7aea53648f5abee861e3fc5876fc4ef61f616a5b0a5d5d42"}
STAMPS = {"ecoli_clr30": "b0206033b7125b82", "ecoli_clr90": "c8c7d4472f65fc0e"}
FAMILIES = [{"name": "arr", "unit_len": 900, "copies": 4, "identity": 0.99, "layout": "tandem"},
            {"name": "mob", "unit_len": 700, "copies": 8, "identity": 0.95,
             "layout": "dispersed"}]


def test_no_repeats_keeps_data_set_and_stamps(tiny_root):
    data = corpus.ensure(tiny_root, {**TINY, "name": "tiny"})
    for name, want in TINY_SHA256.items():
        with open(os.path.join(os.path.dirname(data.prefix), name), "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == want, name
    assert not os.path.exists(os.path.join(os.path.dirname(data.prefix), corpus.REPEATS))
    for name, want in STAMPS.items():
        with open(os.path.join(ROOT, "pbbench", "configs", name + ".json")) as fh:
            cfg = json.load(fh)
        assert corpus.stamp(cfg) == want
        cfg["genome"]["repeats"] = []
        assert corpus.stamp(cfg) == want


def planted(seed, length, families):
    """The genome and the map of its copies, drawn as corpus.py draws them."""
    rng = np.random.default_rng(seed)
    g = simreads.genome(rng, length)
    return g, simreads.plant(rng, g, families)


def oriented(g, copy):
    piece = g[copy["start"] : copy["end"]]
    return revcomp(piece) if copy["strand"] == "-" else piece


def test_families_land_where_the_map_says(tiny_root):
    """Each copy in repeats.json lies at its place and on its strand in the
    genome of the configuration's seed, at the identity drawn; the drawn
    identities lie within 3 s.d. of the family's."""
    cfg = {**TINY, "name": "fams", "corpus_seed": 41,
           "genome": {"length": 20000, "repeats": FAMILIES}}
    data = corpus.ensure(tiny_root, cfg)
    g, drawn = planted(41, 20000, FAMILIES)
    with open(os.path.join(os.path.dirname(data.prefix), corpus.REPEATS)) as fh:
        repeats = json.load(fh)
    assert repeats == drawn
    spans = sorted((c["start"], c["end"]) for c in repeats)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[0][0] >= 0 and spans[-1][1] <= len(g)
    for fam in FAMILIES:
        copies = [c for c in repeats if c["family"] == fam["name"]]
        assert len(copies) == fam["copies"]
        assert all(c["end"] - c["start"] == fam["unit_len"] for c in copies)
        pieces = np.stack([oriented(g, c) for c in copies])
        # the unit: each column's most common base, right where most copies keep it
        unit = np.argmax(np.stack([(pieces == b).sum(0) for b in range(4)]), axis=0)
        p = 1.0 - fam["identity"]
        sd = np.sqrt(p * (1 - p) / fam["unit_len"])
        for c, piece in zip(copies, pieces):
            assert np.mean(piece == unit) == pytest.approx(c["identity"], abs=1e-12)
            assert abs(c["identity"] - fam["identity"]) <= 3 * sd
        if fam["layout"] == "tandem":
            starts = sorted(c["start"] for c in copies)
            assert np.all(np.diff(starts) == fam["unit_len"])
            assert {c["strand"] for c in copies} == {"+"}
    strands = [c["strand"] for c in repeats if c["family"] == "mob"]
    assert "+" in strands and "-" in strands


def test_same_seed_same_genome():
    (a, ma), (b, mb) = planted(7, 20000, FAMILIES), planted(7, 20000, FAMILIES)
    assert np.array_equal(a, b) and ma == mb
    assert not np.array_equal(a, planted(8, 20000, FAMILIES)[0])
    # without families, the uniform genome of old, and no draw added
    g, m = planted(7, 5000, [])
    assert m == [] and np.array_equal(
        g, np.random.default_rng(7).integers(0, 4, 5000, dtype=np.uint8))


@pytest.mark.parametrize("length, family", [
    (5000, {"name": "too_long", "unit_len": 2000, "copies": 3, "identity": 1.0,
            "layout": "tandem"}),
    (3000, {"name": "too_many", "unit_len": 700, "copies": 5, "identity": 1.0,
            "layout": "dispersed"})])
def test_family_that_cannot_fit_raises(length, family):
    with pytest.raises(ValueError, match=repr(family["name"])):
        planted(1, length, [family])
