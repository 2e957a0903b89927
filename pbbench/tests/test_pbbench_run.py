"""The run end to end on the TINY data set with the port's CPU route, and
the run's refusal without a card."""
import json
import os

import pytest
import torch

from pbbench import run

from conftest import assert_host_metrics

E2E = {"corrected_kbp_per_s", "peak_device_gb", "setup_s"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_cell_cpu(tiny_root, capsys):
    line = run.run_cell(tiny_root, "tiny.small", 2**31 + 7, 1.0, False,
                        device="cpu", workers=2)
    out, err = capsys.readouterr()
    assert line["correct"] is True, err[-3000:]
    assert set(line["metrics"]) == E2E
    assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "peak_device_gb")
    assert line["attempted"] >= 4 and line["attempted"] % 4 == 0 and line["failed"] == 0
    assert list(line)[-1] == "check"
    assert line["check"]["mismatched_reads"] == {"value": 0, "limit": 0}
    assert line["check"]["compared_reads"]["value"] >= 1
    # the numbers compared are the last lines on standard error
    assert [s.split()[1] for s in err.strip().splitlines()[-3:]] == list(line["check"])
    assert out.startswith("inputs_s ")
    # a second run finds the data set made
    assert os.path.exists(os.path.join(tiny_root, "pbbench", ".cache", "tiny", "stamp"))


def test_run_cell_cpu_traced(tiny_root, capsys):
    line = run.run_cell(tiny_root, "tiny.small", 5, 1.0, True, device="cpu", workers=1)
    assert line["correct"] is True
    # the device trace's metrics need a card; the host's are all there
    assert_host_metrics(tiny_root, line["metrics"])
    assert "busy_s" not in line["device"]
    json.dumps(line)


def test_main_refuses_without_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "ecoli_clr30.short", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


@pytest.mark.chip
def test_run_cell_on_card(tiny_root, cuda, capsys):
    line = run.run_cell(tiny_root, "tiny.small", 3, 2.0, True, device=cuda, workers=2)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert {"kernels.walk_ms_per_mbp", "device.idle_pct"} <= set(line["metrics"])
