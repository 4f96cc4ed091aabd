"""Discovery by name: a cell's file in ``workloads/``, its configuration in
``configs/``, its traffic kind's driver in ``traffic/`` and each per-layer
metric's reader in ``metrics/``.  What a cell reports is what
``BENCHMARK.json`` lists for it, so a new cell, configuration or metric is
new files and entries, never an edit."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from portbench.harness import ROOT


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT.parent) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, base: Path = ROOT) -> dict:
    return load_json(base / "workloads" / f"{name}.json")


def config(name: str, base: Path = ROOT) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, base: Path = ROOT):
    """The ``Driver`` class of traffic kind ``kind``."""
    return _module(base / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}").Driver


def reader(metric: str, base: Path = ROOT):
    """The ``read(run)`` function of the per-layer metric ``metric``."""
    return _module(base / "metrics" / f"{metric}.py", f"portbench_metric_{metric}").read


def metrics_of(bench: dict, kind: str, workload: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries reported in ``workload``."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]
