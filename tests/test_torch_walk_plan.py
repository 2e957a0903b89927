"""The walk kernels' shared-memory plan (ops/walk.py lane_smem_bytes).

One gap lane's state lives in shared memory for a whole launch; the plan
says how many bytes, where the labels go, and how many lanes share a
block.  Every config the corrector can launch the walk kernels at must
fit one block's 232,448 bytes, and the wrappers' launch arguments must
come from the same plan.
"""
import pytest
import torch

from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams
from longreadselfcorrect_tpu_torch.ops import walk as tw

from test_torch_walk_prep import make_pair, port_tasks
from test_walk import make_tasks

torch.set_num_threads(1)

LADDER = ("cfg", "cfg_lo", "cfg_big", "cfg_huge", "cfg_deep", "cfg_dense")


@pytest.fixture(scope="module")
def walk_corpus():
    return make_pair(33, 6000, 180)


def ladder(c, ck):
    """The corrector's configs at word length ck (8 on small indexes, 12 on
    the bench index); the interval table itself is not needed here."""
    wx = tw.WalkIndex(ix=c["td"], wcache=torch.zeros((1, 4), dtype=torch.int32), ck=ck)
    dev = BatchedSelfCorrector(c["th"], wx, CorrectionParams(pb_coverage=30, genome=10))
    return {name: getattr(dev, name) for name in LADDER}


@pytest.mark.parametrize("name", LADDER)
@pytest.mark.parametrize("ck", [8, 12])
def test_every_config_fits_one_block(walk_corpus, name, ck):
    base = ladder(walk_corpus, ck)[name]
    for kind, cfg in (("", base), ("wide", tw.wide_config(base)),
                      ("dense", tw.dense_config(base))):
        plan = tw.lane_smem_bytes(cfg)
        parts = (plan.records, plan.candidates, plan.results, plan.leaf_src, plan.history)
        assert plan.total == sum(parts) <= tw.SMEM_LIMIT == 232448, (name, kind, plan)
        assert all(p % 16 == 0 for p in parts)
        assert 1 <= plan.warps_per_block <= tw.LANE_WARPS
        assert plan.warps_per_block * plan.total <= tw.SMEM_LIMIT
        # the labels: one (symbol, parent slot) byte per position and slot,
        # in shared memory at every config of the ladder
        assert plan.labels == "shared"
        assert plan.history == (cfg.MAXLEN * cfg.L + 15) // 16 * 16


def test_main_config_plan(walk_corpus):
    """The main config on the bench index (ck = 12): two records of 280
    ints per leaf slot (28 scalars, the chain ring of 4 x 13, the error
    ring of 100 doubles), 16 candidates of 24 ints, 16 result slots of 24
    bytes, 768 x 4 label bytes: 13,968 bytes, four lanes a block."""
    plan = tw.lane_smem_bytes(ladder(walk_corpus, 12)["cfg"])
    assert (plan.records, plan.candidates, plan.results, plan.history,
            plan.total) == (8960, 1536, 384, 3072, 13968)
    assert plan.warps_per_block == 4
    # the widest: L = 32 over 2816 positions, one lane a block
    huge = tw.lane_smem_bytes(tw.wide_config(ladder(walk_corpus, 12)["cfg_huge"]))
    assert huge.history == 32 * 2816 and huge.warps_per_block == 1


def test_plan_refuses_what_does_not_fit():
    for cfg in (tw.WalkConfig(L=32, CAND=128, MAXLEN=6000, QMAX=6000),
                tw.WalkConfig(L=33, CAND=132), tw.WalkConfig(RMAX=65)):
        with pytest.raises(ValueError):
            tw.lane_smem_bytes(cfg)


@pytest.mark.parametrize("L", [4, 32])
def test_launch_arguments_come_from_the_plan(walk_corpus, L):
    """The int arrays of lrsc_walk_steps / lrsc_walk_queue end with the
    plan's lane bytes and its lanes per block (no more than the lanes)."""
    c = walk_corpus
    tasks = port_tasks(make_tasks(c["reads"], None, 3))
    cfg = tw.WalkConfig(G=3, MAXLEN=512, QMAX=512, L=L, CAND=4 * L)
    plan = tw.lane_smem_bytes(cfg)
    wx = tw.WalkIndex.build(c["td"], c["th"])
    consts, state = tw.build_batch(wx, tasks, cfg, 0.15, 30)
    red = tw._reduced_empty(3, cfg, state.code.device)
    _, ints = tw.steps_args(wx, consts, state, red, cfg, 7, on_card=False)
    assert list(ints)[-4:] == [3, 7, plan.total, min(plan.warps_per_block, 3)]
    bank = tw.build_bank(wx, tasks, cfg, 0.15, 30)
    head = torch.zeros(1, dtype=torch.int32)
    _, ints = tw.queue_args(wx, bank, red, head, 3, cfg, 60, on_card=False)
    assert list(ints)[-4:] == [60, 3, plan.total, min(plan.warps_per_block, 3)]
    # on the card only: a CPU tensor is refused where the kernel would run
    with pytest.raises(ValueError):
        tw.steps_args(wx, consts, state, red, cfg, 7)
