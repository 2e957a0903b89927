"""The port's walk engine equals the JAX one, per task.

run_gap_batch (the batch engine to completion, with the wide and dense
reruns) gives each task's (code, merged sequence) as the JAX function
does, and as the host engine does; _reduce_results is compared field by
field.  Mirrors TestDeviceWalk (tests/test_walk.py).  The queue engine is
in test_torch_queue.py.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.ops import walk as jw
from longreadselfcorrect_tpu_torch.ops import walk as tw

from test_torch_walk_prep import (HostWalks, assert_jax_state, configs, index_pair,
                                  make_pair, port_tasks)
from test_walk import host_run, make_tasks

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def walk_corpus():
    return make_pair(33, 6000, 180)


@pytest.mark.parametrize("noisy", [False, True])
def test_run_gap_batch_matches_jax_and_host(walk_corpus, noisy):
    c = walk_corpus
    tasks = make_tasks(c["reads"], None, 12, noisy=noisy)
    jcfg, tcfg = configs(G=12, MAXLEN=512, QMAX=512)
    want = jw.run_gap_batch(c["jh"], c["jd"], tasks, jcfg, 0.15, 30)
    twx = tw.WalkIndex.build(c["td"], c["th"])
    got = tw.run_gap_batch(c["th"], twx, port_tasks(tasks), tcfg, 0.15, 30)
    assert got == want
    for task, (code, seq) in zip(tasks, got):
        assert (code, seq) == host_run(c["jh"], task)


@pytest.mark.parametrize("slab", [False, True])
def test_reduce_results_fields(walk_corpus, slab):
    """run_to_completion + _reduce_results, every output field: those
    the JAX reduction has on the lanes it did not flag, the f64 error
    fields against the host engine, the tie bit the state's."""
    c = walk_corpus
    tasks = make_tasks(c["reads"], None, 10, noisy=True)
    jcfg, tcfg = configs(G=10, MAXLEN=512, QMAX=512, SLAB=slab, SB=2)
    jwx = jw.WalkIndex.build(c["jd"], c["jh"])
    twx = tw.WalkIndex.build(c["td"], c["th"])
    jc, js = jw.build_batch(c["jh"], tasks, jcfg, 0.15, 30, dev_ix=jwx.ix)
    js = jw.run_to_completion(jwx, jc, js, jcfg, 4096)
    want = jw._reduce_results(js, jcfg)
    tc, ts = tw.build_batch(twx, port_tasks(tasks), tcfg, 0.15, 30)
    got = tw.walk_steps(twx, tc, ts, tcfg, 4096)
    keep = ~np.asarray(js.res_overflow)
    for f, w in zip(tw.REDUCED_FIELDS, want):
        a, b = np.asarray(w), getattr(got, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a[keep], b[keep]), f
    assert_jax_state(js, ts, "to completion")
    host = HostWalks(c["th"], port_tasks(tasks))
    host.step(4096)
    assert host.assert_errors(ts, tcfg, "to completion") > 0
    assert torch.equal(got.tie, ts.res_tie)


def test_wide_and_dense_reruns():
    """Lanes that overflow their leaf slots (-200, L=1 here) rerun wide,
    lanes whose slot-0 interval spans more than SB blocks (-300, SB=0
    forces it) rerun dense: both equal the JAX reruns.  Half the reads
    carry a SNP every 40 bases, so the walks branch."""
    rng = np.random.default_rng(5)
    g1 = "".join(rng.choice(list("ACGT"), size=5000))
    g2 = list(g1)
    for j in range(20, len(g2), 40):
        g2[j] = "ACGT"[("ACGT".index(g2[j]) + 1) % 4]
    g2 = "".join(g2)
    reads = []
    for i in range(240):
        p = int(rng.integers(0, len(g1) - 1000))
        reads.append((g1, g2)[i % 2][p : p + 1000])
    c = index_pair(reads)
    tasks = make_tasks(reads[::2], None, 4, noisy=True)
    jwx = jw.WalkIndex.build(c["jd"], c["jh"])
    twx = tw.WalkIndex.build(c["td"], c["th"])
    for kw in (dict(L=1, CAND=4), dict(SLAB=True, SB=0)):
        jcfg, tcfg = configs(G=4, MAXLEN=512, QMAX=512, **kw)
        jc, js = jw.build_batch(c["jh"], tasks, jcfg, 0.15, 30, dev_ix=jwx.ix)
        js = jw.run_to_completion(jwx, jc, js, jcfg, 4096)
        codes = set(np.asarray(js.code).tolist())
        assert codes & {-200, -300}, codes
        want = jw.run_gap_batch(c["jh"], jwx, tasks, jcfg, 0.15, 30)
        got = tw.run_gap_batch(c["th"], twx, port_tasks(tasks), tcfg, 0.15, 30)
        assert got == want
