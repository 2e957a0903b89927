"""BENCHMARK.json's shape, cells found by name from files alone, and the
imports of pbbench's modules."""
import ast
import hashlib
import json
import os
import re
import shutil

import pytest

from pbbench import cells, run

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = os.path.join(ROOT, "pbbench")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "pbbench/run.py"] and b["paths"] == ["pbbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    assert [w["name"] for w in b["workloads"]] == ["ecoli_clr30.short"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("pbbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(PB, "traffic", w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"corrected_kbp_per_s", "peak_device_gb", "setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cell_names = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] == "corrected_kbp_per_s"
        assert set(m["workloads"]) <= cell_names
        assert os.path.exists(os.path.join(PB, "metrics", m["name"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def test_added_files_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as
    files, with entries in BENCHMARK.json, and no other file edited."""
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(PB, os.path.join(root, "pbbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))

    def digests():
        out = {}
        for d, _, files in os.walk(root):
            for f in files:
                p = os.path.join(d, f)
                if f != "BENCHMARK.json":
                    out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
        return out

    before = digests()
    pb = os.path.join(root, "pbbench")
    with open(os.path.join(ROOT, "pbbench", "configs", "ecoli_clr30.json")) as fh:
        cfg = json.load(fh)
    cfg["coverage"] = 60
    cfg["pbcorrect"]["pb_coverage"] = 60
    with open(os.path.join(pb, "configs", "ecoli_clr60.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pb, "traffic", "mid.json"), "w") as fh:
        json.dump({"min_len": 1500, "max_len": 6000, "order": "shuffle", "batch_reads": 64}, fh)
    with open(os.path.join(pb, "metrics", "replay.miss_pct.py"), "w") as fh:
        fh.write("def read(m):\n    s = m.stats\n"
                 "    return 100.0 * s['prefetch_miss'] / max(s['prefetch_hit'], 1)\n")
    b = bench()
    b["configs"].append({"name": "ecoli_clr60", "source": "x",
                         "file": "pbbench/configs/ecoli_clr60.json", "reduced": [], "why": "x"})
    b["workloads"].append({"name": "ecoli_clr60.mid", "config": "ecoli_clr60",
                           "traffic": "mid", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "replay.miss_pct", "unit": "%", "better": "lower",
                           "source": "program_counter", "layer": "replay",
                           "moves": "corrected_kbp_per_s", "workloads": ["ecoli_clr60.mid"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)

    cell = cells.load(root, "ecoli_clr60.mid")
    assert cell.config["coverage"] == 60 and cell.traffic["max_len"] == 6000
    assert [m["name"] for m in cell.per_layer] == ["replay.miss_pct"]
    m = run.Measures(window_s=1.0, reads=2, bases=5000, phase_times={}, timer_dp=0.0,
                     stats={"prefetch_hit": 8, "prefetch_miss": 2})
    assert cells.reader(root, "replay.miss_pct")(m) == 25.0
    after = digests()
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
