"""The check fails what it must: the timed path broken underneath the rest
of a run, and the control (the port with its own ``--nodp`` path on, so
that a gap the walks leave goes uncorrected where pbcorrect runs the
MSA/DP fallback), on the TINY data set with the port's CPU route."""
import copy

import pytest
import torch

from pbbench import run
from longreadselfcorrect_tpu_torch.core.batch_correct import BatchedSelfCorrector

@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unchanged(batch, results):
    """A step that returns its state unchanged: each read comes back as it
    went in."""
    out = []
    for (_, seq), r in zip(batch, results):
        r = copy.copy(r)
        r.corrected_strs = [seq]
        out.append(r)
    return out


def half_left_out(batch, results):
    return results[: len(results) // 2]


def base_altered(batch, results):
    """One base of each corrected read altered where it is produced."""
    out = []
    for r in results:
        r = copy.copy(r)
        r.corrected_strs = [("C" if s[0] != "C" else "G") + s[1:] if s else "A"
                            for s in r.corrected_strs] or ["A"]
        out.append(r)
    return out


@pytest.mark.parametrize("fault", [unchanged, half_left_out, base_altered])
def test_fault_fails(tiny_root, monkeypatch, fault):
    real = BatchedSelfCorrector.process_stream

    def broken(self, batches):
        fed = []

        def feed():
            for b in batches:
                fed.append(b)
                yield b
        for k, results in enumerate(real(self, feed())):
            yield fault(fed[k], results)

    monkeypatch.setattr(BatchedSelfCorrector, "process_stream", broken)
    line = run.run_cell(tiny_root, "tiny.small", 9, 1.0, False, device="cpu", workers=2)
    assert line["correct"] is False


def test_control_readings_in_one_process(tiny_root):
    """control.py's readings: the program sound, the control not, on two
    seeds with the data set opened once."""
    from pbbench import control

    s = run.open_cell(tiny_root, "tiny.small", "cpu")
    out = control.readings(s, [21, 22], 3.0, program=True, workers=2)
    assert [(r["seed"], r["side"], r["correct"]) for r in out] == [
        (21, "program", True), (21, "control", False),
        (22, "program", True), (22, "control", False)]
