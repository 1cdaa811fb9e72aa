"""Finds what a cell is made of, by the names in BENCHMARK.json: its
configuration file, its traffic file (`traffic/<name>.json`), the reader of
each metric (`metrics/<name>.py`, a `read(ctx)` function) and the spans
(`spans/<name>.json`) that a reader names in its `SPANS`. Adding a configuration, a traffic mix, a
metric or a span is adding files; nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # slambench/


def repo_root(bench_dir: str = HERE) -> str:
    return os.path.dirname(bench_dir)


def load_benchmark(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str, bench_dir: str = HERE) -> dict:
    """Everything one cell needs: its entry, its configuration and traffic
    (parsed), and the names of its end-to-end and per-layer metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"]), encoding="utf-8") as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"), encoding="utf-8") as f:
        traffic = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"workload": w, "config": config, "traffic": traffic, "bench_dir": bench_dir,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def metric_module(name: str, bench_dir: str = HERE):
    """metrics/<name>.py as a module."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = HERE) -> Callable:
    """The `read(ctx)` of metrics/<name>.py."""
    return metric_module(name, bench_dir).read


def spans(metrics: List[Dict], bench_dir: str = HERE) -> List[Dict]:
    """The span files that the readers of `metrics` name in their `SPANS`,
    by name: {"name", "root", "path", "attr", ...}. Only these are
    installed, so a span added for another cell's metric leaves this
    cell's timings as they were."""
    names = sorted({n for m in metrics
                    for n in getattr(metric_module(m["name"], bench_dir), "SPANS", ())})
    out = []
    for name in names:
        with open(os.path.join(bench_dir, "spans", name + ".json"), encoding="utf-8") as f:
            s = json.load(f)
        s["name"] = name
        out.append(s)
    return out
