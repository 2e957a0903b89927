"""BENCHMARK.json's shape, cells found by name from files alone, and the
imports of pbbench's modules."""
import ast
import hashlib
import json
import os
import re

import pytest
import torch

from pbbench import cells, run

from conftest import (ROOT, TINY_REPEATS, add_cell, assert_host_metrics, make_root,
                      read_bench, write_bench)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = os.path.join(ROOT, "pbbench")


SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E = {"corrected_kbp_per_s", "peak_device_gb", "setup_s"}   # what run.py measures


def check_shape(root):
    """BENCHMARK.json of the checkout at root holds to the benchmark's
    contract, over every config, cell and metric it has."""
    b = read_bench(root)
    pb = os.path.join(root, "pbbench")
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "pbbench/run.py"] and b["paths"] == ["pbbench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(configs) == len(b["configs"]) and len(cells) == len(b["workloads"])
    assert "ecoli_clr30.short" in cells
    assert 1 <= len(configs) <= 24 and 1 <= len(cells) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("pbbench/") and os.path.exists(os.path.join(root, c["file"]))
        with open(os.path.join(root, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    assert len({c["file"] for c in b["configs"]}) == len(configs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(pb, "traffic", w["traffic"] + ".json"))
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == E2E
    for m in b["end_to_end"]:
        # no "workloads": every cell reports every end-to-end metric
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert os.path.exists(os.path.join(pb, "metrics", m["name"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for w in cells:
        # a per-layer metric in every cell
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_benchmark_json_shape():
    check_shape(ROOT)


def digests(root):
    """sha256 of every file under root but BENCHMARK.json."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if f != "BENCHMARK.json":
                with open(p, "rb") as fh:
                    out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_files_found_by_name(tmp_path, capsys):
    """A configuration with a repeat family, a traffic mix, a cell and a
    host per-layer metric added as files and entries alone: the shape holds,
    the cell is found by name and its traced run reports the new metric,
    and no file that was there is edited."""
    root = make_root(str(tmp_path))
    before = digests(root)
    pb = os.path.join(root, "pbbench")
    with open(os.path.join(pb, "metrics", "replay.miss_pct.py"), "w") as fh:
        fh.write("def read(m):\n    s = m.stats\n"
                 "    return 100.0 * s['prefetch_miss'] / max(s['prefetch_hit'], 1)\n")
    add_cell(root, "tiny_rep.mid", "tiny_rep", "mid", cfg=TINY_REPEATS,
             mix={"min_len": 300, "max_len": 700, "order": "shuffle", "batch_reads": 4})
    b = read_bench(root)
    b["per_layer"].append({"name": "replay.miss_pct", "unit": "%", "better": "lower",
                           "source": "program_counter", "layer": "replay",
                           "moves": "corrected_kbp_per_s", "workloads": ["tiny_rep.mid"]})
    write_bench(root, b)
    check_shape(root)

    cell = cells.load(root, "tiny_rep.mid")
    assert cell.config["genome"]["repeats"][0]["name"] == "rep1k"
    assert cell.traffic["max_len"] == 700
    assert "replay.miss_pct" in [m["name"] for m in cell.per_layer]
    m = run.Measures(window_s=1.0, reads=2, bases=5000, phase_times={}, timer_dp=0.0,
                     stats={"prefetch_hit": 8, "prefetch_miss": 2})
    assert cells.reader(root, "replay.miss_pct")(m) == 25.0
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        line = run.run_cell(root, "tiny_rep.mid", 13, 1.0, True, device="cpu", workers=1)
    finally:
        torch.set_num_threads(n)
    assert line["correct"] is True, capsys.readouterr().err[-3000:]
    assert_host_metrics(root, line["metrics"])
    assert "replay.miss_pct" in line["metrics"]
    assert os.path.exists(os.path.join(pb, ".cache", "tiny_rep", "repeats.json"))
    after = digests(root)
    assert {p: h for p, h in after.items() if p in before} == before


def top_imports(path):
    """Top-level names of the absolute imports of a source file."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        if ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, PB))
def test_no_jax(path):
    bad = {"jax", "jaxlib", "flax", "longreadselfcorrect_tpu"}
    assert not set(top_imports(path)) & bad


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, PB))
def test_reference_imports_nothing_of_the_port(path):
    assert set(top_imports(path)) <= {"__future__", "copy", "dataclasses", "json", "math",
                                      "numpy", "os", "struct", "time"}
