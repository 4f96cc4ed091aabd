"""``BENCHMARK.json`` against the benchmark's contract, discovery of cells,
configurations and metrics by name from new files, and the import check."""

from __future__ import annotations

import ast
import json
import re
import sys

import pytest

from portbench import harness, run, spec
from portbench.tests import tiny

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_meets_the_contract():
    path = harness.ROOT.parent / "BENCHMARK.json"
    assert path.stat().st_size <= 64 * 1024
    b = spec.benchmark()
    assert list(b) == TOP_KEYS
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["reduced"] == []
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (harness.ROOT.parent / c["file"]).exists()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and _line(w["why"])
        assert NAME.fullmatch(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.cell(w["name"])
        assert (cell["name"], cell["config"], cell["traffic"], cell["why"]) == (
            w["name"], w["config"], w["traffic"], w["why"])
    assert {w["config"] for w in b["workloads"]} == configs
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.fullmatch(m["unit"]) and _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        for w in m["workloads"]:  # each cell listed reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in b["workloads"]:
        reported = [m["name"] for m in spec.metrics_of(b, "end_to_end", w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(b, "per_layer", w["name"])


def test_every_name_is_found_by_discovery():
    b = spec.benchmark()
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        assert spec.config(cell["config"])["name"] == cell["config"]
        assert callable(spec.driver(cell["kind"]))
        assert set(cell["check"]["limits"])
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_new_cell_configuration_and_metric_are_new_files(tmp_path):
    """A cell, a configuration and a per-layer metric added as files alone
    run without an edit to the harness."""
    base = tiny.make_base(tmp_path)
    (base / "metrics" / "t.points_in_window.py").write_text(
        "def read(run):\n    return float(len(run.units)) if run.units else None\n")
    bench = tiny.bench_with_tiny()
    bench["per_layer"].append({"name": "t.points_in_window", "unit": "points",
                               "workloads": ["t_flood"]})
    result, _ = tiny.run_tiny(base, bench, "t_flood", trace=1)
    assert result["metrics"]["t.points_in_window"]["value"] >= 1
    assert "mc.device_idle_pct" not in result["metrics"]  # no device on the CPU


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in harness.ROOT.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "math", "pathlib", "numpy", "torch",
                        "portbench"}, path
        assert not any(n.startswith("portbench.") and not n.startswith("portbench.reference")
                       for n in _imports(path)), path


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qkd_ldpc_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxfake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "qkd_ldpc_tpu.sim", object())
    assert run.forbidden_modules() == ["jax", "qkd_ldpc_tpu"]


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """The benchmark's own modules and the program they drive, in a fresh
    interpreter: nothing of JAX comes in."""
    import subprocess

    code = ("import sys; from portbench import run, spec, harness, trace, arith; "
            "from portbench.traffic import _points, mc_point, mc_continuation, serve_open, "
            "sweep; import qkd_ldpc_tpu_torch.sim.runner, qkd_ldpc_tpu_torch.serve, "
            "qkd_ldpc_tpu_torch.sim.continuation; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().replace("'", '"')) == []


@pytest.mark.card
def test_every_cell_runs_correct_on_the_card(tmp_path):
    """Each cell, briefly, on the card: exit 0 and ``correct`` true."""
    import subprocess

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for w in spec.benchmark()["workloads"]:
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"],
                              "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
                             capture_output=True, text=True, cwd=harness.ROOT.parent,
                             timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
