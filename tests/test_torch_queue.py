"""The port's queue engine equals the JAX one, per task.

submit_queue_batch / collect_queue_batch give each task's (code, merged
sequence) as the JAX functions do, and as the host engine does where the
device keeps the gap.  Mirrors TestQueueEngine (tests/test_walk.py) and
test_queue_bank_1024_tasks (tests/test_batch_correct.py).
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.ops import walk as jw
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.ops import walk as tw

from test_torch_walk_prep import configs, make_pair, port_tasks
from test_walk import host_run, make_tasks

# the walks' tensors are small: one torch thread is faster, and keeps the
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def walk_corpus():
    return make_pair(33, 6000, 180)


@pytest.mark.parametrize("noisy,slab", [(False, False), (True, True)])
def test_queue_matches_jax_and_host(walk_corpus, noisy, slab):
    c = walk_corpus
    tasks = make_tasks(c["reads"], None, 24, noisy=noisy)
    jcfg, tcfg = configs(G=8, MAXLEN=512, QMAX=512, SLAB=slab)
    jwx = jw.WalkIndex.build(c["jd"], c["jh"])
    twx = tw.WalkIndex.build(c["td"], c["th"])
    want = jw.collect_queue_batch(c["jh"], jwx, jw.submit_queue_batch(
        c["jh"], jwx, tasks, jcfg, 0.15, 30), 0.15, 30)
    h = tw.submit_queue_batch(twx, port_tasks(tasks), tcfg, 0.15, 30)
    got = tw.collect_queue_batch(c["th"], twx, h, 0.15, 30)
    assert got == want
    for task, (code, seq) in zip(tasks, got):
        if code != -100:
            assert (code, seq) == host_run(c["jh"], task)


def test_queue_timeout_and_unrun(walk_corpus):
    """A task still walking after max_steps supersteps is -900; tasks past
    n are never run (code 0)."""
    c = walk_corpus
    _, tcfg = configs(G=4, MAXLEN=512, QMAX=512)
    twx = tw.WalkIndex.build(c["td"], c["th"])
    bank = tw.build_bank(twx, port_tasks(make_tasks(c["reads"], None, 6)), tcfg, 0.15, 30)
    red = tw.walk_queue(twx, bank, 5, tcfg, 60)
    assert red.code.tolist()[:5] == [-900] * 5 and red.code[5] == 0
    full = tw.walk_queue(twx, bank, 6, tcfg, 4096)
    assert set(full.code.tolist()) == {1}


def test_queue_bank_1030_tasks():
    """A 1030-task bank through the primary (slab, SB=2) config: every
    task equals the JAX queue engine, and the host engine on a spot check
    (tests/test_batch_correct.py::test_queue_bank_1024_tasks)."""
    c = make_pair(99, 9000, 270)
    genome = c["genome"]
    g2 = np.random.default_rng(51)
    tasks = []
    for t in range(1030):
        p = int(g2.integers(0, len(genome) - 400))
        gap = 40 + t % 60
        path = list(genome[p + 17 : p + 17 + gap])
        for j in range(0, len(path), 11):
            path[j] = "ACGT"[int(g2.integers(0, 4))]
        tasks.append(jw.GapTask(
            src=genome[p : p + 17], path="".join(path),
            trg=genome[p + 17 + gap : p + 37 + gap], dis=gap, init_k=17,
            max_overlap=19, min_overlap=13, min_sa_threshold=3))
    cfg = tw.WalkConfig(G=64, MAXLEN=640, QMAX=640, WSCAN=320)
    dev = BatchedSelfCorrector(c["th"], c["td"], CorrectionParams(pb_coverage=30, genome=10),
                               cfg=cfg)
    h = tw.submit_queue_batch(dev.wx, port_tasks(tasks), dev.cfg, 0.15, 30)
    got = tw.collect_queue_batch(c["th"], dev.wx, h, 0.15, 30)
    jcfg = jw.WalkConfig(**{k: getattr(dev.cfg, k) for k in (
        "G", "L", "CAND", "MAXLEN", "QMAX", "TMAX", "RMAX", "RING", "KMAX", "WSCAN",
        "seed_size", "max_leaves", "CK", "SLAB", "SB")})
    jwx = jw.WalkIndex.build(c["jd"], c["jh"])
    want = jw.collect_queue_batch(c["jh"], jwx, jw.submit_queue_batch(
        c["jh"], jwx, tasks, jcfg, 0.15, 30), 0.15, 30)
    assert got == want
    from longreadselfcorrect_tpu.core.extend import FMExtendParams, HostExtendEngine

    n_checked = 0
    for t, (code, seq) in zip(tasks[::13], got[::13]):
        if code == -100:
            continue
        eng = HostExtendEngine(c["jh"], t.src, t.path, t.trg, t.dis, t.init_k,
                               t.max_overlap, FMExtendParams(pb_coverage=30, error_rate=0.15),
                               t.min_sa_threshold)
        hcode, hres = eng.extend()
        assert code == hcode and (code <= 0 or seq == hres.merged_seq)
        n_checked += 1
    assert n_checked >= 60
