"""What a run needs, found by name: the cell in `BENCHMARK.json`, its
configuration, traffic and limits files, and the reader of each metric."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, bench: dict, root: str = ROOT) -> dict:
    """The cell `name` with everything its run reads: {name, chips,
    config (the configuration's file, with its `frames`), traffic (the
    traffic file), limits,
    end_to_end and per_layer (the metric entries that apply to it)}."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    if "frames" in traffic:
        raise ValueError(f"traffic {w['traffic']!r} sets frames: the configuration's scale")

    def applies(m):
        return name in m.get("workloads", [name])

    return dict(
        name=name, chips=int(w["chips"]), config=config,
        traffic=traffic,
        limits=limits(name),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def limits(name: str) -> dict:
    """The cell's limits ({number: {limit, lower, upper, ...}}), or {} where
    none are set yet."""
    path = os.path.join(HERE, "limits", f"{name}.json")
    return load_json(path)["numbers"] if os.path.exists(path) else {}


def reader(metric: str):
    """`read(record) -> float | None` of `metrics/<metric>.py`."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    name = "sfmbench_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
