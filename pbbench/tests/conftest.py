"""pbbench's tests.  Tests that need an NVIDIA GPU carry the ``chip``
marker and skip, from inside the test, where there is none."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


# a data set small enough for the port's CPU route: 20 kb at 30x, reads of
# 100-700 bp at CLR's error, so that the DP fallback and the host engine
# both run
TINY = {
    "genome": {"length": 20000},
    "reads": {"length_mean": 400, "length_sd": 150, "length_min": 100, "length_max": 700,
              "accuracy_mean": 0.85, "accuracy_sd": 0.02, "accuracy_min": 0.75,
              "accuracy_max": 0.90, "error_ratio_sub_ins_del": [10, 60, 30]},
    "coverage": 30,
    "corpus_seed": 11,
    "pbcorrect": {"pb_coverage": 30, "error_rate": 0.15, "genome": 5},
    "reduced": [],
}


# TINY with one planted family: a 1 kb unit at 6 copies, identity 0.995,
# so that the seed phase finds repeat seeds and the replay the variants of
# an accumulated source
TINY_REPEATS = {**TINY, "corpus_seed": 12,
                "genome": {"length": 20000, "repeats": [
                    {"name": "rep1k", "unit_len": 1000, "copies": 6, "identity": 0.995,
                     "layout": "dispersed"}]}}

# the host metrics (program spans and counters) that every traced run
# reports, on the CPU too
HOST_TODAY = {"seed.host_s_per_mbp", "walks.host_s_per_mbp", "walks.gaps_per_kbp",
              "replay.host_s_per_mbp", "replay.host_fallback_pct", "dp.replay_share_pct"}


def read_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def write_bench(root: str, bench: dict) -> None:
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)


def add_cell(root: str, cell: str, config: str, traffic: str, cfg: dict | None = None,
             mix: dict | None = None) -> None:
    """Adds a cell to the checkout at root as files and entries alone: the
    configuration's file where cfg is given, the mix's where mix is, the
    cell, and the cell in every per-layer metric's list."""
    bench = read_bench(root)
    if cfg is not None:
        with open(os.path.join(root, "pbbench", "configs", config + ".json"), "w") as fh:
            json.dump({"source": "a test data set", **cfg}, fh)
        bench["configs"].append({"name": config, "source": "a test data set",
                                 "file": f"pbbench/configs/{config}.json",
                                 "reduced": cfg["reduced"], "why": "CPU tests"})
    if mix is not None:
        with open(os.path.join(root, "pbbench", "traffic", traffic + ".json"), "w") as fh:
            json.dump(mix, fh)
    bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                               "chips": 1, "why": "CPU tests"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(cell)
    write_bench(root, bench)


def host_layers(root: str) -> set[str]:
    """The per-layer metrics of the checkout read from the program's spans
    and counters."""
    return {m["name"] for m in read_bench(root)["per_layer"]
            if m["source"] in ("program_span", "program_counter")}


def assert_host_metrics(root: str, metrics: dict) -> None:
    """A traced line of a CPU run: each of HOST_TODAY, any other host metric
    a finite number or absent (its reader found nothing), and no device
    metric."""
    import math

    assert HOST_TODAY <= set(metrics) <= host_layers(root)
    assert all(math.isfinite(v["value"]) for v in metrics.values())


def make_root(dest: str) -> str:
    """A checkout of the benchmark under dest: BENCHMARK.json, pbbench/
    (no cache, no tests) and native/'s sources, with one more cell,
    tiny.small, on the TINY data set: every read, in batches of 4."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "pbbench"), os.path.join(dest, "pbbench"),
                    ignore=shutil.ignore_patterns(".cache", "tests", "__pycache__"))
    os.makedirs(os.path.join(dest, "native"))
    for name in ("Makefile", "fmbuild.cpp"):
        shutil.copy(os.path.join(ROOT, "native", name), os.path.join(dest, "native"))
    add_cell(dest, "tiny.small", "tiny", "small", cfg=TINY,
             mix={"order": "shuffle", "batch_reads": 4})
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))
