"""The replay's spans and counters on a CLR read set (the port on the CPU),
and the walks that tie there.

BatchedSelfCorrector times the host engine, the MSA/DP fallback and the
miss rounds inside the replay (phase_times "replay.host_engine",
"replay.dp", "replay.rounds") and counts why the walks flagged each gap
they left to the host engine (stats fl_*: result slots, no end,
max_leaves; fl_hazard, the f32 tie the walk once flagged, reads 0) and
the hits whose walk resolved a tie among leaves at the minimum error
(walk_ties).  On CLR reads at 15% error some walks meet such a tie: the
JAX walk flags them (f32), the port walks them in f64 to the host engine's
own answer.  The outputs stay the JAX host SelfCorrector's; the spans
never overlap and fit inside the replay; each flagged lookup has exactly
one reason.
"""
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.core.correct import CorrectionParams as JParams
from longreadselfcorrect_tpu.core.correct import SelfCorrector as JSelfCorrector
from longreadselfcorrect_tpu.index.fmindex import FMIndex as JFMIndex
from longreadselfcorrect_tpu.index.fmindex import IndexSet as JIndexSet
from longreadselfcorrect_tpu.index.host import HostFM as JHostFM
from longreadselfcorrect_tpu.index.host import HostIndexSet as JHostIndexSet
from longreadselfcorrect_tpu.ops import walk as jw
from longreadselfcorrect_tpu_torch import cli
from longreadselfcorrect_tpu_torch.core import seeds as seedmod
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.ops import walk
from pbbench import simreads

from test_torch_correct import COUNTERS
from test_torch_walk_prep import HostWalks, port_tasks

torch.set_num_threads(1)

# a 20 kb genome at 30x of 100-700 bp CLR reads (PBSIM's model, ~85%
# accurate), pbcorrect -c 30 -e 0.15 -g 5
GENOME, COVERAGE, CORPUS_SEED = 20000, 30, 11
READS = {"length_mean": 400, "length_sd": 150, "length_min": 100, "length_max": 700,
         "accuracy_mean": 0.85, "accuracy_sd": 0.02, "accuracy_min": 0.75,
         "accuracy_max": 0.90, "error_ratio_sub_ins_del": [10, 60, 30]}
PARAMS = {"pb_coverage": 30, "error_rate": 0.15, "genome": 5}


def clr_corpus(d):
    """The CLR read set, indexed through the port's CLI under d: (reads
    [(rid, seq)] in a fixed shuffled order, host index, torch index)."""
    rng = np.random.default_rng(CORPUS_SEED)
    bases, offsets, _ = simreads.clr_reads(rng, simreads.genome(rng, GENOME), READS,
                                           float(COVERAGE))
    fa = str(d / "reads.fa")
    simreads.write_fasta(fa, bases, offsets)
    assert cli.main(["index", fa, "-p", str(d / "reads"), "--pure-python"]) == 0
    hix, dix = open_index(str(d / "reads"), device="cpu")
    order = np.random.default_rng(1).permutation(len(offsets) - 1)
    reads = [(f"r{i}", simreads.read_str(bases, offsets, int(i))) for i in order]
    return reads, hix, dix


def flagged_tasks(corrector, reads):
    """The gap tasks the reads enumerate (host seeds), the reason the plain
    walk gives each -100 (None for the others) and each task's tie bit."""
    per_read = [(rid, seq, seedmod.search_seeds(seq, corrector.ix, corrector.probe_params,
                                                corrector.thresh))
                for rid, seq in reads]
    tasks, _ = corrector._enumerate_walks(per_read)
    why: list = []
    ties: list = []
    walk.run_gap_batch(corrector.ix, corrector.wx, tasks,
                       replace(corrector.cfg, G=len(tasks)), 0.15, 30, why=why, ties=ties)
    return tasks, why, ties


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    reads, hix, dix = clr_corpus(tmp_path_factory.mktemp("clr"))
    jhix = JHostIndexSet(JHostFM(hix.bwt.symbols, hix.bwt.num_strings),
                         JHostFM(hix.rbwt.symbols, hix.rbwt.num_strings))
    return reads, hix, dix, jhix


@pytest.mark.parametrize("prefetch", ["all", "half"])
def test_replay_spans_and_counters(corpus, monkeypatch, prefetch):
    """8 reads in one batch; with prefetch "half" every other enumerated
    gap is left out of the first device round, so the miss rounds run and
    reads are replayed.  A gap of 45 bases is made to fit no device config
    (fb_unfit), so the host engine runs: no walk is flagged any more."""
    reads, hix, dix, jhix = corpus
    fits_any = BatchedSelfCorrector._fits_any

    def unfit_45(self, src, path, trg, interval, ek):
        return interval != 45 and fits_any(self, src, path, trg, interval, ek)

    monkeypatch.setattr(BatchedSelfCorrector, "_fits_any", unfit_45)
    if prefetch == "half":
        enumerate_walks = BatchedSelfCorrector._enumerate_walks

        def every_other(self, per_read):
            tasks, keys = enumerate_walks(self, per_read)
            return tasks[::2], keys[::2]

        monkeypatch.setattr(BatchedSelfCorrector, "_enumerate_walks", every_other)
    items = reads[:8]
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(**PARAMS))
    got = port.process_batch(items)
    host = JSelfCorrector(jhix, JParams(**PARAMS))
    for (rid, seq), res in zip(items, got):
        want = host.process(rid, seq)
        for name in COUNTERS:
            assert getattr(res, name) == getattr(want, name), (rid, name)

    st, pt = port.stats, port.phase_times
    assert st["fl_hazard"] == 0 and st["walk_ties"] > 0 and st["fb_unfit"] > 0, st
    assert sum(st["fl_" + r] for r in walk.FLAG_REASONS) == st["fb_flagged"], st
    assert st["host_fallback"] == st["fb_flagged"] + st["fb_unfit"] + st["fb_lastround"]
    assert st["he_calls"] == st["host_fallback"]
    assert 0 <= st["he_fail"] <= st["he_calls"] and 0 <= st["he_repeat"] <= st["he_calls"]
    spans = [pt["replay." + name] for name in ("host_engine", "dp", "rounds")]
    assert all(s >= 0 for s in spans) and sum(spans) <= pt["replay"]
    assert pt["replay.host_engine"] > 0 and pt["replay.dp"] > 0
    assert 0 <= st["dp_discarded_s"] <= pt["replay.dp"]
    # the host engine's seconds reach the results that kept them
    fm = [r.timer_fm for r in got]
    assert any(t > 0 for t in fm)
    assert sum(fm) <= pt["replay.host_engine"] * (1 + 1e-9)
    if prefetch == "all":
        assert st["miss_rounds"] == st["miss_tasks"] == st["prefetch_miss"] == 0
        assert pt["replay.rounds"] == 0 and st["dp_discarded_s"] == 0
        assert st["he_repeat"] == 0
        assert math.isclose(sum(fm), pt["replay.host_engine"], rel_tol=1e-9)
    else:
        assert st["miss_rounds"] > 0 and st["miss_tasks"] >= st["miss_rounds"]
        assert st["prefetch_miss"] > 0 and pt["replay.rounds"] > 0


def test_flag_reasons_of_the_walk(corpus):
    """run_gap_batch and collect_queue_batch give each -100 one reason and
    leave their (code, seq) pairs as they were: none on these tasks, whose
    ties the walk decides (tie bits, equal on both engines), and lanes cut
    at max_steps (unfinished).  (A -200 lane at max_leaves, reason leaves,
    needs L >= max_leaves, where the walk ends a lane of more than
    max_leaves leaves with 1 or -3 before -200.)"""
    reads, hix, dix, _ = corpus
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(**PARAMS))
    tasks, why, ties = flagged_tasks(port, reads[:24])
    assert why == [None] * len(tasks) and any(ties) and not all(ties)
    cfg = replace(port.cfg, G=len(tasks))
    plain = walk.run_gap_batch(hix, port.wx, tasks, cfg, 0.15, 30)
    for max_steps in (4096, 20):
        w_batch, w_queue, t_batch, t_queue = [], [], [], []
        got = walk.run_gap_batch(hix, port.wx, tasks, cfg, 0.15, 30, max_steps, why=w_batch,
                                 ties=t_batch)
        h = walk.submit_queue_batch(port.wx, tasks, cfg, 0.15, 30, max_steps)
        got_q = walk.collect_queue_batch(hix, port.wx, h, 0.15, 30, why=w_queue,
                                         ties=t_queue)
        for res, w in ((got, w_batch), (got_q, w_queue)):
            assert [x is None for x in w] == [c != -100 for c, _ in res]
            assert set(w) - {None} <= set(walk.FLAG_REASONS) - {"hazard"}
        if max_steps == 4096:
            assert got == plain == got_q and w_batch == why == w_queue
            assert t_batch == ties == t_queue
        else:
            assert "unfinished" in w_batch and "unfinished" in w_queue


@pytest.mark.parametrize("wide", [False, True])
def test_tie_lanes_match_host(corpus, wide):
    """The gaps the JAX walk flags (-100) on an f32 tie among leaves at
    the minimum error: the port's batch and queue engines return, per
    task, the host engine's (code, sequence), at the corrector's bulk
    config and at L = max_leaves; every other gap still gets the JAX
    walk's (code, sequence)."""
    reads, hix, dix, jhix = corpus
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(**PARAMS))
    tasks, _, ties = flagged_tasks(port, reads[:24])
    cfg = replace(port.cfg, G=len(tasks))
    cfg = walk.wide_config(cfg) if wide else cfg
    jd = JIndexSet(bwt=JFMIndex.from_symbols(hix.bwt.symbols, hix.bwt.num_strings),
                   rbwt=JFMIndex.from_symbols(hix.rbwt.symbols, hix.rbwt.num_strings))
    jcfg = jw.WalkConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jtasks = [jw.GapTask(**{f: getattr(t, f) for f in t.__dataclass_fields__}) for t in tasks]
    want = jw.run_gap_batch(jhix, jw.WalkIndex.build(jd, jhix, ck=cfg.CK), jtasks, jcfg,
                            0.15, 30)
    flagged = [g for g, (c, _) in enumerate(want) if c == -100]
    assert flagged and all(ties[g] for g in flagged), (flagged, ties)
    got = walk.run_gap_batch(hix, port.wx, tasks, cfg, 0.15, 30)
    got_q = walk.collect_queue_batch(hix, port.wx, walk.submit_queue_batch(
        port.wx, tasks, cfg, 0.15, 30), 0.15, 30)
    for g, t in enumerate(tasks):
        for res in (got, got_q):
            if g in flagged:
                assert res[g] == host_code_seq(hix, t), g
            else:
                assert res[g] == want[g], g


def host_code_seq(hix, t):
    """(code, merged sequence) of the task by the host engine."""
    eng = HostWalks(hix, [t]).eng[0]
    code, res = eng.extend()
    return code, res.merged_seq
