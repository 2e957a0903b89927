"""The port on a genome with a planted repeat family (TINY_REPEATS), with
its CPU route: the seed phase finds repeat seeds, the walks phase plans
the variants of an accumulated source, and the run's check against the
reference passes."""
import pytest
import torch

from pbbench import run
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector

from conftest import TINY_REPEATS, add_cell, make_root


@pytest.fixture(scope="module")
def rep_root(tmp_path_factory):
    root = make_root(str(tmp_path_factory.mktemp("checkout")))
    # reads of 500 bp or more, 8 a batch: the seed below draws a batch with
    # repeat seeds and an accumulated-source variant
    add_cell(root, "tiny_rep.long", "tiny_rep", "long", cfg=TINY_REPEATS,
             mix={"min_len": 500, "order": "shuffle", "batch_reads": 8})
    return root


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_repeat_paths_run_and_match_reference(rep_root, monkeypatch, capsys):
    counts = {"seeds": 0, "repeat_seeds": 0, "pending_b": 0}
    enum_read, enum_finalize = BatchedSelfCorrector._enum_read, BatchedSelfCorrector._enum_finalize

    def counted_read(self, st, seq, seeds):
        counts["seeds"] += len(seeds)
        counts["repeat_seeds"] += sum(s.is_repeat for s in seeds)
        return enum_read(self, st, seq, seeds)

    def counted_finalize(self, st):
        counts["pending_b"] += len(st["pending_b"])
        return enum_finalize(self, st)

    monkeypatch.setattr(BatchedSelfCorrector, "_enum_read", counted_read)
    monkeypatch.setattr(BatchedSelfCorrector, "_enum_finalize", counted_finalize)
    line = run.run_cell(rep_root, "tiny_rep.long", 2**31 + 21, 1.0, False,
                        device="cpu", workers=2)
    err = capsys.readouterr().err
    with capsys.disabled():
        print(f"\ntiny_rep.long: {line['attempted']} reads, {counts}")
    assert line["correct"] is True, err[-3000:]
    assert line["check"]["mismatched_reads"]["value"] == 0
    assert counts["repeat_seeds"] > 0
