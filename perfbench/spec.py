"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs[].file``) and
a traffic mix (``traffic/<traffic>.json``); a per-layer metric is read by
``metrics/<name>.py``'s ``read(record)``.  A later change adds a cell, a mix
or a metric with new files and a new entry, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}: BENCHMARK.json names {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    return {
        **entry,
        "cfg": config,
        "mix": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
    }


def reader(metric: str):
    """``read(record)`` of ``metrics/<metric>.py`` (the name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
