"""The port's plain rank primitives equal the JAX package's ops.rank.

Every compared value is an int32 count or interval end, so every
comparison is exact equality (np.array_equal), never a tolerance.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.index.fmindex import FMIndex as JFMIndex
from longreadselfcorrect_tpu.index.fmindex import IndexSet as JIndexSet
from longreadselfcorrect_tpu.ops import rank as jrank
from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.index import build
from longreadselfcorrect_tpu_torch.index.fmindex import FMIndex, IndexSet
from longreadselfcorrect_tpu_torch.index.pack import pack_symbols
from longreadselfcorrect_tpu_torch.ops import rank

import jax.numpy as jnp


@pytest.fixture(scope="module")
def pair():
    """The same random multi-read index in both implementations."""
    rng = np.random.default_rng(5)
    reads = [ab.encode("".join(rng.choice(list("ACGT"), size=int(rng.integers(50, 400)))))
             for _ in range(40)]
    fwd, rev = build.build_bwt_pair(reads)
    packs = {}
    for name, bwt in (("bwt", fwd), ("rbwt", rev)):
        blocks, ckpt, C = pack_symbols(bwt.symbols)
        packs[name] = (blocks, ckpt, C, bwt.num_symbols, bwt.num_strings)
    tix = IndexSet(bwt=FMIndex.from_pack(*packs["bwt"], "cpu"),
                   rbwt=FMIndex.from_pack(*packs["rbwt"], "cpu"))
    jix = JIndexSet(bwt=JFMIndex.from_pack(*packs["bwt"]),
                    rbwt=JFMIndex.from_pack(*packs["rbwt"]))
    return tix, jix, reads


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _idx(n, rng, size=300):
    """Query positions with the edges: -1 (empty prefix), 0 and n-1."""
    return np.concatenate([[-1, 0, n - 1], rng.integers(-1, n, size=size)]).astype(np.int32)


def test_from_pack_matches_jax(pair):
    tix, jix, _ = pair
    for t, j in ((tix.bwt, jix.bwt), (tix.rbwt, jix.rbwt)):
        assert np.array_equal(t.blocks.numpy(), np.asarray(j.blocks))
        assert np.array_equal(t.ckpt.numpy(), np.asarray(j.ckpt))
        assert np.array_equal(t.C.numpy(), np.asarray(j.C))
        assert (t.n, t.num_strings, t.block) == (j.n, j.num_strings, j.block)
        assert t.blocks.dtype == torch.int8 and t.ckpt.dtype == torch.int32
        assert t.C.dtype == torch.int32 and t.blocks.device.type == "cpu"


@pytest.mark.parametrize("strand", ["bwt", "rbwt"])
def test_occ_and_occ_all(pair, strand):
    tix, jix, _ = pair
    t, j = getattr(tix, strand), getattr(jix, strand)
    rng = np.random.default_rng(11)
    idx = _idx(t.n, rng)
    for sym in range(5):
        s = np.full_like(idx, sym)
        got = rank.occ(t, _t(s), _t(idx)).numpy()
        want = np.asarray(jrank.occ(j, jnp.asarray(s), jnp.asarray(idx)))
        assert np.array_equal(got, want), sym
    assert rank.occ(t, _t([2]), _t([-1])).tolist() == [0]
    got = rank.occ_all(t, _t(idx)).numpy()
    assert np.array_equal(got, np.asarray(jrank.occ_all(j, jnp.asarray(idx))))


@pytest.mark.parametrize("strand", ["bwt", "rbwt"])
def test_update_interval(pair, strand):
    tix, jix, _ = pair
    t, j = getattr(tix, strand), getattr(jix, strand)
    rng = np.random.default_rng(12)
    lo = _idx(t.n, rng) + 1          # lo in [0, n]: lo - 1 = -1 included
    hi = _idx(t.n, rng)              # hi in [-1, n-1]; lo > hi is invalid
    for sym in range(5):
        s = np.full_like(lo, sym)
        got = rank.update_interval(t, _t(lo), _t(hi), _t(s))
        want = jrank.update_interval(j, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(s))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), sym


def test_bi_ladder(pair):
    """init_bi + 40 extend_bi steps on words from the reads and random words."""
    tix, jix, reads = pair
    rng = np.random.default_rng(13)
    words = [r[:41] for r in reads[:20]]
    words += [rng.integers(0, 5, size=41).astype(np.int8) for _ in range(12)]
    words = np.stack(words).astype(np.int32)   # includes $ (0) symbols
    sym = words[:, 0]
    ts = rank.init_bi(tix, _t(sym))
    js = jrank.init_bi(jix, jnp.asarray(sym))
    assert np.array_equal(rank.comp(_t(sym)).numpy(), np.asarray(jrank.comp(jnp.asarray(sym))))
    for k in range(1, words.shape[1]):
        for g, w in zip(ts, js):
            assert np.array_equal(g.numpy(), np.asarray(w)), k
        assert np.array_equal(rank.bi_freq(ts).numpy(), np.asarray(jrank.bi_freq(js)))
        ts = rank.extend_bi(tix, ts, _t(words[:, k]))
        js = jrank.extend_bi(jix, js, jnp.asarray(words[:, k]))
    freq = rank.bi_freq(ts).numpy()
    assert (freq[:20] >= 1).all()   # the read-derived words exist in the index
