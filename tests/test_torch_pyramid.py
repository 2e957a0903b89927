"""The walk index's interval-table pyramid (ops/walk.py get_tables), which
kmer_table_full reads each lane's first levels from.

Every level j <= ck (8 and 10) equals the JAX package's tables: its host
trie (index/host.py init_bi / extend_bi, the recipe of _build_kmer_caches,
whose level 8 it is) and its _wcache_level_up above CACHE_K; and the plain
ladder's interval (rank.init_bi, then extend_bi) of every j-mer (a sample
above level 8).  The exactness traps of reading the table in place of the
ladder: an entry is the ladder's interval only for an all-ACGT word; an
empty interval stays empty (size 0) under LF.  A walk index opened over a
pack with wcache{ck}.npy loads level ck and extends only the levels below.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from longreadselfcorrect_tpu.ops import walk as jw
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.ops import rank
from longreadselfcorrect_tpu_torch.ops import walk as tw

from test_torch_walk_prep import make_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus():
    """tests/test_walk.py's corpus (seed 33): exact 1 kb reads of a 6 kb
    genome, JAX and port indexes."""
    return make_pair(33, 6000, 180)


def jax_levels(c, ck):
    """Levels 1..ck by the JAX package: its host trie to CACHE_K, then its
    device level-up."""
    jh = c["jh"]
    sym1 = np.arange(1, 5, dtype=np.int64)
    state = list(jh.init_bi(sym1))
    out = [np.stack(state, axis=1).astype(np.int32)]
    for _ in range(min(ck, jw.CACHE_K) - 1):
        n = len(state[0])
        state = list(jh.extend_bi(tuple(np.repeat(x, 4) for x in state), np.tile(sym1, n)))
        out.append(np.stack(state, axis=1).astype(np.int32))
    if ck >= jw.CACHE_K:
        assert np.array_equal(out[jw.CACHE_K - 1], jw._build_kmer_caches(jh)[0])
    fused = jw.WalkIndex.build(c["jd"], jh, ck=jw.CACHE_K).fused
    st = tuple(jnp.asarray(out[-1][:, i]) for i in range(4))
    for _ in range(jw.CACHE_K, ck):
        st = jw._wcache_level_up(fused, *st)
        out.append(np.stack([np.asarray(x) for x in st], axis=1).astype(np.int32))
    return out


def words(j, codes):
    """int64 [n, j] symbols 1..4 of the j-mers with these 2-bit codes."""
    shifts = 2 * (j - 1 - np.arange(j))
    return torch.from_numpy(((codes[:, None] >> shifts) & 3) + 1)


def ladder(td, syms):
    """The plain ladder's interval of each row of syms, left to right."""
    st = rank.init_bi(td, syms[:, 0])
    for i in range(1, syms.shape[1]):
        st = rank.extend_bi(td, st, syms[:, i])
    return torch.stack(st, dim=1)


@pytest.mark.parametrize("ck", [8, 10])
def test_pyramid_levels_match_jax_and_the_ladder(corpus, ck):
    c = corpus
    wx = tw.WalkIndex.build(c["td"], c["th"], ck=ck)
    assert tuple(wx.pyramid.shape) == ((4 ** ck - 4) // 3, 4)
    assert wx.pyramid.dtype == torch.int32 and wx.level(ck) is wx.wcache
    want = jax_levels(c, ck)
    rng = np.random.default_rng(ck)
    for j in range(1, ck + 1):
        lev = wx.level(j)
        assert np.array_equal(lev.numpy(), want[j - 1]), j
        codes = (np.arange(4 ** j) if j <= 8
                 else rng.choice(4 ** j, size=4000, replace=False))
        got = ladder(c["td"], words(j, codes))
        assert torch.equal(lev[torch.from_numpy(codes)], got), j
    # the table is not trivially empty: most 8-mers of a read occur
    read = c["reads"][0]
    code8 = [int("".join(str("ACGT".index(ch)) for ch in read[p : p + 8]), 4)
             for p in range(0, 400, 8)]
    lev8 = wx.level(8)[code8]
    assert ((lev8[:, 1] >= lev8[:, 0]) & (lev8[:, 3] >= lev8[:, 2])).all()


def test_empty_intervals_stay_empty(corpus):
    """Each child of an empty strand interval is empty, of size exactly 0
    (hi = lo - 1): the ladder may stop stepping a strand once it is empty,
    and read its size as 0 from any level, table or ladder."""
    c = corpus
    wx = tw.WalkIndex.build(c["td"], c["th"], ck=10)
    seen = 0
    for j in range(1, 10):
        par = wx.level(j)
        kid = wx.level(j + 1).reshape(4 ** j, 4, 4)
        for lo, hi in ((0, 1), (2, 3)):
            empty = par[:, lo] > par[:, hi]
            seen += int(empty.sum())
            assert (par[empty, hi] - par[empty, lo] == -1).all()
            assert (kid[empty][:, :, lo] > kid[empty][:, :, hi]).all()
            assert (kid[empty][:, :, hi] - kid[empty][:, :, lo] == -1).all()
    assert seen > 1000


def test_table_entry_is_the_ladder_only_for_acgt(corpus):
    """A word with a rank-0 symbol ('$', what an N reads as) has another
    interval than the table entry of any all-ACGT word, e.g. the one with
    that symbol read as A: a lane must leave the table at its first
    non-ACGT symbol."""
    c = corpus
    wx = tw.WalkIndex.build(c["td"], c["th"], ck=8)
    rng = np.random.default_rng(3)
    codes = rng.choice(4 ** 8, size=2000, replace=False)
    syms = words(8, codes)
    at = torch.from_numpy(rng.integers(0, 8, size=len(codes)))
    syms[torch.arange(len(codes)), at] = 0
    got = ladder(c["td"], syms)
    as_a = torch.where(syms == 0, 1, syms)
    key = ((as_a - 1) << torch.from_numpy(2 * (7 - np.arange(8)))).sum(1)
    table = wx.level(8)[key]
    assert torch.equal(ladder(c["td"], as_a), table)
    size = (got[:, 1] - got[:, 0] + 1).clamp(min=0) + (got[:, 3] - got[:, 2] + 1).clamp(min=0)
    tsize = (table[:, 1] - table[:, 0] + 1).clamp(min=0) + (table[:, 3] - table[:, 2] + 1).clamp(min=0)
    # (two empty intervals can coincide)
    assert (got != table).any(dim=1).float().mean() > 0.9
    assert (size != tsize).any()


def test_pack_top_level_loaded_lower_levels_rebuilt(tmp_path, corpus, monkeypatch):
    """wcache{ck}.npy beside the pack is loaded as level ck; the levels
    below are built again (one level-up, 8 -> 9, at ck = 10) and equal a
    fresh build; reuse=False extends every level."""
    from longreadselfcorrect_tpu.index import store as jstore

    c = corpus
    prefix = str(tmp_path / "reads")
    jstore.save_native(prefix, c["fwd"], c["rev"])
    hix, dix = open_index(prefix, device="cpu")
    fresh = tw.WalkIndex.build(dix, hix, ck=10)
    path = prefix + ".pack/wcache10.npy"
    assert os.path.exists(path)
    ups = []
    orig = tw.wcache_level_up
    monkeypatch.setattr(tw, "wcache_level_up", lambda *a: ups.append(1) or orig(*a))
    hix2, dix2 = open_index(prefix, device="cpu")
    loaded = tw.WalkIndex.build(dix2, hix2, ck=10)
    assert len(ups) == 1
    assert torch.equal(loaded.pyramid, fresh.pyramid)
    assert torch.equal(loaded.wcache, fresh.wcache)
    tw.WalkIndex.build(dix2, hix2, ck=10, reuse=False)
    assert len(ups) == 3
