"""The port's four seedscan functions (plain versions) equal the JAX kernels.

Each function is fed the SAME JAX-made inputs as its JAX counterpart.  The
outputs are int32 / bool (and the f32 compare outcomes behind them), so
every comparison is exact equality (np.array_equal).
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.index.fmindex import FMIndex as JFMIndex
from longreadselfcorrect_tpu.index.fmindex import IndexSet as JIndexSet
from longreadselfcorrect_tpu.ops import scan as jscan
from longreadselfcorrect_tpu.ops import seedscan as jseedscan
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.core.threshold import KmerThreshold
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.ops import seedscan

import jax.numpy as jnp


def seedscan_corpus():
    """tests/test_seedscan.py's corpus: seed 17, 20 kb genome, 400 ~1 kb
    reads at ~9% error, both strands."""
    rng = np.random.default_rng(17)
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    reads = []
    for i in range(400):
        p = int(rng.integers(0, 20000 - 1000))
        out = []
        for ch in genome[p : p + 1000]:
            x = rng.random()
            if x < 0.05:
                out.append("ACGT"[int(rng.integers(0, 4))])
            elif x < 0.07:
                pass
            elif x < 0.09:
                out.append(ch)
                out.append("ACGT"[int(rng.integers(0, 4))])
            else:
                out.append(ch)
        r = "".join(out)
        reads.append(ab.revcomp_str(r) if i % 2 else r)
    return genome, reads


def _chunk(seqs, R, L):
    mat = np.full((R, L), ab.PAD_RANK, np.int8)
    lens = np.zeros(R, np.int32)
    for i, s in enumerate(seqs):
        e = ab.encode(s)
        mat[i, : len(e)] = e
        lens[i] = len(e)
    return mat, lens


def _jax_stage_inputs(jix, seqs, R, L, pp, thresh):
    """The JAX seed phase of one chunk, stage by stage (batch_correct.py:
    _seed_submit), as numpy arrays."""
    mat, lens = _chunk(seqs, R, L)
    max_k = pp.kmer_len_up_bound + 1
    dmat, dlens = jnp.asarray(mat), jnp.asarray(lens)
    freq, valid = jscan.kmer_table_full(jix, dmat, dlens, max_k)
    onehot = dmat[:, :, None] == jnp.arange(1, 5, dtype=jnp.int8)
    prefix = jnp.pad(jnp.cumsum(onehot, axis=1, dtype=jnp.int32),
                     ((0, 0), (1, 0), (0, 0)))
    rep_thr = jnp.float32(thresh.get(2, pp.scan_kmer_len))
    thr = jnp.asarray(thresh.table[:, : max_k + 1])
    attr = jseedscan._attributes(freq[pp.scan_kmer_len], prefix, dlens, rep_thr,
                                 pp.scan_kmer_len)
    auto = jseedscan._scan_automaton(
        freq, valid, attr, prefix, dlens, thr, pp.start_kmer_len,
        pp.kmer_len_up_bound, tuple(pp.offset), float(pp.hh_ratio))
    n, starts, sizes, freqs, reps, statics = auto
    best = jseedscan._estimate_best(freq, n, starts, sizes, statics, pp.pb_coverage)
    keep = jseedscan._remove_hitchhiking(n, starts, sizes, freqs, reps, pp.radius,
                                         float(pp.hh_ratio))
    out = dict(freq=freq, valid=valid, prefix=prefix, lens=dlens, attr=attr,
               thr=thr, auto=auto, best=best, keep=keep)
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in out.items()}


def _jax_index(reads):
    fwd, rev = build.build_bwt_pair([ab.encode(r) for r in reads])
    return JIndexSet(bwt=JFMIndex.from_symbols(fwd.symbols, fwd.num_strings),
                     rbwt=JFMIndex.from_symbols(rev.symbols, rev.num_strings))


@pytest.fixture(scope="module")
def stages():
    """Two chunks over the corpus index plus reads that carry two 200-bp
    repeat units, A in 600 reads and B in 320 (half per strand), so their
    k-mers occur 600 and 320 times, above the mode-2 thresholds.

    main: 48 corpus reads (R=64, L=1280).
    smax (R=2, L=7168): a clean 7 kb genome segment whose ~50-bp seeds
    overflow the 128 seed slots (the slot-127 overwrite path), beside a read
    with A + B + A inside: mode-2 attributes, repeat seeds, and B's seeds
    hitchhiked by A's from both sides (freq ratios 320/600 < 0.6 and
    600/320 > 1/0.6)."""
    genome, reads = seedscan_corpus()
    rng = np.random.default_rng(29)
    unit_a, unit_b = ("".join(rng.choice(list("ACGT"), size=200)) for _ in range(2))
    rep_reads = []
    for unit, copies in ((unit_a, 600), (unit_b, 320)):
        for i in range(copies):
            flank = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(2)]
            r = flank[0] + unit + flank[1]
            rep_reads.append(ab.revcomp_str(r) if i % 2 else r)
    jix = _jax_index(reads + rep_reads)
    params = CorrectionParams(pb_coverage=20, genome=10)
    pp, _, _ = params.derived()
    thresh = KmerThreshold(-1, 50, params.pb_coverage)
    seqs = reads[:48]
    L = 256 * ((max(map(len, seqs)) + 255) // 256)
    main = _jax_stage_inputs(jix, seqs, 64, L, pp, thresh)
    with_repeat = genome[12000:13000] + unit_a + unit_b + unit_a + genome[13000:14000]
    full = _jax_stage_inputs(jix, [genome[3000:10000], with_repeat], 2, 7168,
                             pp, thresh)
    return pp, {"main": main, "smax": full}


CHUNKS = ["main", "smax"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_attributes_matches_jax(stages, chunk):
    pp, st = stages
    s = st[chunk]
    thresh = KmerThreshold(-1, 50, pp.pb_coverage)
    got = seedscan.attributes(_t(s["freq"][pp.scan_kmer_len]), _t(s["prefix"]),
                              _t(s["lens"]), float(thresh.get(2, pp.scan_kmer_len)),
                              pp.scan_kmer_len)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), s["attr"])
    if chunk == "smax":
        assert (s["attr"][1] == 2).any()   # the repeat read has mode-2 positions


@pytest.mark.parametrize("chunk", CHUNKS)
def test_scan_automaton_matches_jax(stages, chunk):
    pp, st = stages
    s = st[chunk]
    got = seedscan.scan_automaton(
        _t(s["freq"]), _t(s["valid"]), _t(s["attr"]), _t(s["prefix"]), _t(s["lens"]),
        _t(s["thr"]), pp.start_kmer_len, pp.kmer_len_up_bound, tuple(pp.offset),
        float(pp.hh_ratio))
    for g, w in zip(got, s["auto"]):
        assert np.array_equal(g.numpy(), w)
    n = s["auto"][0]
    if chunk == "main":
        assert n.sum() > 100
    else:
        assert n[0] == seedscan.SMAX   # slots full: slot 127 was overwritten
        reps = s["auto"][4]
        assert reps[1, : n[1]].any()   # the repeat read has repeat seeds


@pytest.mark.parametrize("chunk", CHUNKS)
def test_estimate_best_matches_jax(stages, chunk):
    pp, st = stages
    s = st[chunk]
    n, starts, sizes, _, _, statics = s["auto"]
    got = seedscan.estimate_best(_t(s["freq"]), _t(n), _t(starts), _t(sizes),
                                 _t(statics), pp.pb_coverage)
    for g, w in zip(got, s["best"]):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_remove_hitchhiking_matches_jax(stages, chunk):
    pp, st = stages
    s = st[chunk]
    n, starts, sizes, freqs, reps, _ = s["auto"]
    got = seedscan.remove_hitchhiking(_t(n), _t(starts), _t(sizes), _t(freqs),
                                      _t(reps), pp.radius, float(pp.hh_ratio))
    assert np.array_equal(got.numpy(), s["keep"])
    if chunk == "smax":
        assert (~s["keep"][1, : n[1]]).any()   # hitchhikers were dropped
