"""pbbench's tests.  Tests that need an NVIDIA GPU carry the ``chip``
marker and skip, from inside the test, where there is none."""
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


def make_root(dest: str) -> str:
    """A checkout of the benchmark under dest: BENCHMARK.json, pbbench/
    (no cache, no tests) and native/'s sources, with one more cell,
    tiny.small, on the TINY data set: every read, in batches of 4."""
    import json

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "pbbench"), os.path.join(dest, "pbbench"),
                    ignore=shutil.ignore_patterns(".cache", "tests", "__pycache__"))
    os.makedirs(os.path.join(dest, "native"))
    for name in ("Makefile", "fmbuild.cpp"):
        shutil.copy(os.path.join(ROOT, "native", name), os.path.join(dest, "native"))
    with open(os.path.join(dest, "pbbench", "configs", "tiny.json"), "w") as fh:
        json.dump({"source": "a test data set", **TINY}, fh)
    with open(os.path.join(dest, "pbbench", "traffic", "small.json"), "w") as fh:
        json.dump({"order": "shuffle", "batch_reads": 4}, fh)
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny", "source": "a test data set",
                             "file": "pbbench/configs/tiny.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny.small", "config": "tiny", "traffic": "small",
                               "chips": 1, "why": "CPU tests"})
    for m in bench["per_layer"]:
        m["workloads"].append("tiny.small")
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))
