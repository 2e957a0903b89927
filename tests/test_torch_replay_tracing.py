"""The replay's spans and counters on a CLR read set (the port on the CPU).

BatchedSelfCorrector times the host engine, the MSA/DP fallback and the
miss rounds inside the replay (phase_times "replay.host_engine",
"replay.dp", "replay.rounds") and counts why the walks flagged each gap
they left to the host engine (stats fl_*: the walk's f32-tie hazard bit,
result slots, no end, max_leaves).  On CLR reads at 15% error some walks
end on an f32 tie and are flagged, so every counter has work.  The outputs
stay the JAX host SelfCorrector's; the spans never overlap and fit inside
the replay; each flagged lookup has exactly one reason.
"""
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu.core.correct import CorrectionParams as JParams
from longreadselfcorrect_tpu.core.correct import SelfCorrector as JSelfCorrector
from longreadselfcorrect_tpu.index.host import HostFM as JHostFM
from longreadselfcorrect_tpu.index.host import HostIndexSet as JHostIndexSet
from longreadselfcorrect_tpu_torch import cli
from longreadselfcorrect_tpu_torch.core import seeds as seedmod
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.index.pack import open_index
from longreadselfcorrect_tpu_torch.ops import walk
from pbbench import simreads

from test_torch_correct import COUNTERS

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
    """The gap tasks the reads enumerate (host seeds) and the reason the
    plain walk gives each -100 (None for the others)."""
    per_read = [(rid, seq, seedmod.search_seeds(seq, corrector.ix, corrector.probe_params,
                                                corrector.thresh))
                for rid, seq in reads]
    tasks, _ = corrector._enumerate_walks(per_read)
    why: list = []
    walk.run_gap_batch(corrector.ix, corrector.wx, tasks,
                       replace(corrector.cfg, G=len(tasks)), 0.15, 30, why=why)
    return tasks, why


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
    reads are replayed."""
    reads, hix, dix, jhix = corpus
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
    assert st["fb_flagged"] > 0 and st["fl_hazard"] > 0, st
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
    leave their (code, seq) pairs as they were: the walk's hazard bit on
    these tasks, and lanes cut at max_steps (unfinished).  (A -200 lane at
    max_leaves, reason leaves, needs L >= max_leaves, where the walk ends
    a lane of more than max_leaves leaves with 1 or -3 before -200.)"""
    reads, hix, dix, _ = corpus
    port = BatchedSelfCorrector(hix, dix, CorrectionParams(**PARAMS))
    tasks, why = flagged_tasks(port, reads[:24])
    assert "hazard" in why and None in why
    cfg = replace(port.cfg, G=len(tasks))
    plain = walk.run_gap_batch(hix, port.wx, tasks, cfg, 0.15, 30)
    for max_steps in (4096, 20):
        w_batch, w_queue = [], []
        got = walk.run_gap_batch(hix, port.wx, tasks, cfg, 0.15, 30, max_steps, why=w_batch)
        h = walk.submit_queue_batch(port.wx, tasks, cfg, 0.15, 30, max_steps)
        got_q = walk.collect_queue_batch(hix, port.wx, h, 0.15, 30, why=w_queue)
        for res, w in ((got, w_batch), (got_q, w_queue)):
            assert [x is None for x in w] == [c != -100 for c, _ in res]
            assert set(w) - {None} <= set(walk.FLAG_REASONS)
        if max_steps == 4096:
            assert got == plain == got_q and w_batch == why == w_queue
        else:
            assert "unfinished" in w_batch and "unfinished" in w_queue
