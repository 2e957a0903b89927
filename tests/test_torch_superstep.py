"""The port's plain superstep equals JAX superstep field by field.

40 supersteps from the same prepared state; after every step each WalkState
field (ints, bools, int8 labels, f32 error rates) must be bit-equal
(tolerance 0: the fields feed compares).  The matrix covers the dense and
the slab engine (SB=2), L=4 and the wide retry config L=32, KMAX 24 and 19
(cfg_lo), chain-cache words ck 8 and 10, clean and noisy gaps.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.ops import walk as jw
from longreadselfcorrect_tpu_torch.ops import walk as tw

from test_torch_walk_prep import JAX_STATE_FIELDS, configs, hazard_ok, make_pair, port_tasks
from test_walk import make_tasks

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

STEPS = 40


@pytest.fixture(scope="module")
def walk_corpus():
    return make_pair(33, 6000, 180)


# (slab, L, KMAX, ck, noisy): each axis value appears in several cases
MATRIX = [
    (False, 4, 24, 8, False),
    (False, 4, 24, 8, True),
    (True, 4, 24, 8, True),
    (True, 32, 24, 8, True),
    (False, 32, 19, 10, True),
    (True, 4, 19, 10, False),
    (True, 4, 19, 8, True),
    (False, 4, 24, 10, True),
]


@pytest.mark.parametrize("slab,L,kmax,ck,noisy", MATRIX)
def test_superstep_matches_jax(walk_corpus, slab, L, kmax, ck, noisy):
    c = walk_corpus
    G = 12
    jcfg, tcfg = configs(G=G, MAXLEN=512, QMAX=512, SLAB=slab, SB=2, L=L,
                         CAND=4 * L, KMAX=kmax, CK=ck)
    tasks = make_tasks(c["reads"], None, G, noisy=noisy)
    jwx = jw.WalkIndex.build(c["jd"], c["jh"], ck=ck)
    twx = tw.WalkIndex.build(c["td"], c["th"], ck=ck)
    jc, js = jw.build_batch(c["jh"], tasks, jcfg, 0.15, 30, dev_ix=jwx.ix)
    tc, ts = tw.build_batch(twx, port_tasks(tasks), tcfg, 0.15, 30)
    for step in range(STEPS):
        js = jw.superstep(jwx, jc, js, jcfg)
        ts = tw.superstep_plain(twx, tc, ts, tcfg)
        for f in JAX_STATE_FIELDS:
            a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (step, f)
            assert np.array_equal(a, b), (step, f, np.argwhere(a != b)[:5])
        assert hazard_ok(ts), step
    # the walk advanced: every lane grew its label
    assert bool((ts.cur_len > tc.init_k).all())


def test_error_rate_fma_rounding():
    """fma_f32 rounds a*b + c once, ties included, as a fused multiply-add
    does (exact rational arithmetic as the yardstick)."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    a = rng.integers(-50, 300, 4000).astype(np.float32)
    b = np.full(4000, np.float32(0.15))
    c = rng.integers(-50, 800, 4000).astype(np.float32)
    # a few products whose f64 sum lands exactly on an f32 midpoint
    a[:3] = np.float32(1 + 2**-23)
    b[:3] = np.float32(1 + 2**-23)
    c[:3] = np.float32(-1.0)
    got = tw.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cand = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cand, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.float32(v).view(np.int32)) & 1))
        assert r == best, (x, y, z, r, best)
