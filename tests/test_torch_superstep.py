"""The port's plain superstep equals JAX superstep field by field, and
its f64 error rates equal the host engine's.

40 supersteps from the same prepared state; after every step each WalkState
field the JAX walk shares (ints, bools, int8 labels) must be bit-equal on
the lanes JAX did not flag, and the f64 error fields (local and global
error, num_redeem_seed, the error ring, the results' errors) bit-equal to
the host engine walking the same tasks (tolerance 0: the fields feed
compares).  The matrix covers the dense and the slab engine (SB=2), L=4
and the wide retry config L=32, KMAX 24 and 19 (cfg_lo), chain-cache words
ck 8 and 10, clean and noisy gaps.  computeErrorRate and the
num_redeem_seed adds are held to HostExtendEngine's own code step by step.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.ops import walk as jw
from longreadselfcorrect_tpu_torch.ops import walk as tw

from longreadselfcorrect_tpu_torch.core.extend import HostExtendEngine, Leaf

from test_torch_walk_prep import HostWalks, assert_jax_state, configs, make_pair, port_tasks
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
    host = HostWalks(c["th"], port_tasks(tasks))
    for step in range(STEPS):
        js = jw.superstep(jwx, jc, js, jcfg)
        ts = tw.superstep_plain(twx, tc, ts, tcfg)
        host.step()
        assert_jax_state(js, ts, step)
        assert host.assert_errors(ts, tcfg, step) > 0, step
    # the walk advanced: every lane grew its label
    assert bool((ts.cur_len > tc.init_k).all())


def test_error_rate_fma_rounding():
    """error_rates rounds every operation of computeErrorRate once, as the
    host engine's Python floats do: no fused multiply-add.  The yardstick
    is exact rational arithmetic rounded to f64 after each operation; the
    first rows are chosen so that a contracted err * total - old * (total
    - RING) would round otherwise."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    n, ring, ss = 4000, 100, 9
    covl = rng.integers(20, 900, n)
    ts = np.minimum(rng.integers(0, 400, n), covl)
    nrs = rng.integers(0, 60, n) * 0.85 + rng.integers(0, 20, n) * 1.2
    old = (rng.random(n) - 0.2) * 0.4
    wrap = rng.random(n) < 0.7
    wrap[:50] = True
    gerr, local = tw.error_rates(torch.from_numpy(ts), torch.from_numpy(covl),
                                 torch.from_numpy(nrs), torch.from_numpy(old),
                                 torch.from_numpy(wrap), ss, ring)

    def r(x):                     # one rounding to f64
        return Fraction(float(x))

    fused = 0
    for i in range(n):
        total = Fraction(int(covl[i]))
        matched = r(Fraction(int(ts[i]) + ss - 1) + Fraction(float(nrs[i])))
        g = r(r(total - matched) / total)
        assert float(gerr[i]) == float(g), i
        want = g
        if wrap[i]:
            o = Fraction(float(old[i]))
            want = r(r(r(g * total) - r(o * (total - ring))) / ring)
            fused += float(r(r(g * total - r(o * (total - ring))) / ring)) != float(want)
        assert float(local[i]) == float(want), i
    assert fused > 0


# host events of one PrunedBySeedSupport step of a leaf: a found seed past
# seed_size (adds (ss-1)*e), a found seed near the last (no add), a miss
# past seed_size (adds 1-e), a miss counted as an error (no add), a step
# between seed checks (adds 1-e)
EVENTS = ("hit", "found", "miss", "error", "between")


def host_seed_step(eng, leaf, event):
    """One step of the host engine's PrunedBySeedSupport on leaf (its own
    code, core/extend.py), the leaf's bookkeeping set so that the step
    takes the event's branch; the seed search returns found or not."""
    ss = eng.seed_size
    eng.current_length += 1
    leaf.curr_overlap_len += 1
    curr = eng.current_length - ss
    leaf.last_seed_idx_offset = 0
    if event == "between":
        leaf.last_overlap_len = eng.current_length - 2
    else:
        leaf.last_overlap_len = eng.current_length - ss - 1
        leaf.last_seed_idx = curr - {"hit": ss + 1, "found": ss // 2, "miss": ss + 2,
                                     "error": ss + 1}[event]
    found = event in ("hit", "found")

    def search(lf, small, large):
        if found:
            lf.last_seed_idx = curr
            lf.last_overlap_len = lf.curr_overlap_len = eng.current_length
            lf.total_seeds += 1
        return found

    eng._is_supported_by_new_seed = search
    kept = [leaf]
    eng._pruned_by_seed_support(kept)
    assert kept == [leaf]


@pytest.mark.parametrize("e", [0.15, 0.13, 0.1])
def test_error_rate_step_matches_host(e):
    """add_redeem and error_rates, driven step by step beside a
    HostExtendEngine leaf through PrunedBySeedSupport and computeErrorRate
    on seeded sequences of the five events, past RING global errors: every
    num_redeem_seed, global and local error equal the host's bit for bit.
    The same walk with e widened from f32 differs (the constant trap)."""
    rng = np.random.default_rng(int(e * 1000))
    ss, ring, steps = 9, 100, 260
    eng = HostExtendEngine.__new__(HostExtendEngine)
    eng.seed_size, eng.local_k, eng.pacbio_error_rate = ss, ring, e
    eng.error_rate_bound, eng.max_indel, eng.query = float("inf"), 20, "A" * 10**4
    eng.current_length = 30
    leaf = Leaf(full="", fwd_lo=0, fwd_hi=-1, rvc_lo=0, rvc_hi=-1, total_seeds=22,
                curr_overlap_len=30, local_err=[0.0], global_err=[0.0])
    events = rng.choice(EVENTS, size=steps, p=[0.3, 0.1, 0.25, 0.1, 0.25])
    twins = {"host e": tw.redeem_adds(e, ss),
             "f32 e": tw.redeem_adds(float(np.float32(e)), ss)}
    state = {k: dict(nrs=torch.zeros(1, dtype=torch.float64),
                     ring=torch.zeros(ring, dtype=torch.float64)) for k in twins}
    differs = False
    for n, ev in enumerate(events, start=1):
        host_seed_step(eng, leaf, ev)
        n_app = n + 1                       # the root's error is the first
        for k, redeem in twins.items():
            st = state[k]
            st["nrs"] = tw.add_redeem(st["nrs"], torch.tensor([ev == "hit"]),
                                      torch.tensor([ev in ("miss", "between")]), redeem)
            gerr, local = tw.error_rates(
                torch.tensor([leaf.total_seeds]), torch.tensor([leaf.curr_overlap_len]),
                st["nrs"], st["ring"][n_app % ring].reshape(1),
                torch.tensor([n_app >= ring]), ss, ring)
            st["ring"][(n_app - 1) % ring] = gerr[0]
            got = (float(st["nrs"][0]), float(gerr[0]), float(local[0]))
            want = (leaf.num_redeem_seed, leaf.global_err[-1], leaf.local_err[-1])
            if k == "host e":
                assert got == want, (n, ev, got, want)
            else:
                differs |= got != want
    assert n_app > ring and set(events) == set(EVENTS)
    assert differs
