"""Find a cell's configuration, traffic mix and metric readers by name.

Everything that belongs to one configuration, one mix or one per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json`` (through the entry's ``file``),
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.  Adding one takes a
new file and a new entry, and no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, workload: str) -> Cell:
    """The cell of BENCHMARK.json named workload, with its files read."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}; "
                       f"it has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = _load_json(os.path.join(root, entry["file"]))
    config["name"] = entry["name"]
    traffic = _load_json(os.path.join(root, "pbbench", "traffic", w["traffic"] + ".json"))
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def reader(root: str, metric: str):
    """The read(measures) function of metrics/<metric>.py."""
    path = os.path.join(root, "pbbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "pbbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
