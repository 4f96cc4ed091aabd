"""A tiny copy of the benchmark's cells for the CPU: the same drivers,
readers and limits, on a 640-bit quasi-cyclic code, built from new files
in a directory of its own (the harness finds them by name)."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from portbench import harness, run, spec
from portbench.reference import codes

# the real cell each tiny cell stands for: its kind and its limits
STANDS_FOR = {"t_flood": "mc_qc_flood_q050", "t_cont": "mc_qc_cont_q0825",
              "t_serve": "serve_qc_steady", "t_sweep": "sweep_ref_example"}


def write_alist(g: codes.Graph, path: Path) -> None:
    vars_of = [[] for _ in range(g.n_vars)]
    for c, vs in enumerate(g.checks):
        for v in vs:
            vars_of[v].append(c + 1)
    dv, dc = max(map(len, vars_of)), g.dc_max
    lines = [f"{g.n_vars} {g.n_checks}", f"{dv} {dc}",
             " ".join(str(len(x)) for x in vars_of), " ".join(str(len(c)) for c in g.checks)]
    lines += [" ".join(map(str, x + [0] * (dv - len(x)))) for x in vars_of]
    lines += [" ".join(str(v + 1) for v in list(c) + [-1] * (dc - len(c))) for c in g.checks]
    path.write_text("\n".join(lines) + "\n")


def make_base(root: Path) -> Path:
    """A benchmark directory holding the real drivers and readers and the
    tiny configurations and cells."""
    base = root / "bench"
    for d in ("traffic", "metrics"):
        shutil.copytree(harness.ROOT / d, base / d)
    (base / "configs").mkdir()
    (base / "workloads").mkdir()
    code = {"kind": "qc", "z": 32, "nb": 20, "mb": 10, "dv": 3, "seed": 666,
            "n_vars": 640, "n_checks": 320, "n_edges": 1920}
    dec = {"algorithm": "sum-product", "max_iterations": 100, "clip_messages": True,
           "message_threshold": 100.0, "storage": "bfloat16"}
    (base / "configs" / "tiny_qc.json").write_text(json.dumps(
        {"name": "tiny_qc", "code": code, "decoder": dec}))
    write_alist(codes.qc_graph(32, 20, 10, 3, 7), base / "configs" / "tiny.alist")
    sweep = json.loads((harness.ROOT / "configs" / "ref_alist_n10240.json").read_text())["sweep"]
    sweep = dict(sweep, trials_number=96, code_rate_QBER_parameters=[
        {"code_rate": 0.6, "QBER_begin": 0.05, "QBER_end": 0.08, "QBER_step": 0.015}])
    (base / "configs" / "tiny_alist.json").write_text(json.dumps(
        {"name": "tiny_alist", "code": dict(code, kind="alist", file="tiny.alist"),
         "decoder": dec, "sweep": sweep}))
    params = {
        "t_flood": dict(qber=0.07, trials=384, batch=128, compact_after=8, compact_lanes=32,
                        max_batches_per_dispatch=64, warm_points=1),
        "t_cont": dict(qber=0.08, trials=384, batch=128, segment=4, refill_frac=0.25,
                       warm_points=1),
        "t_serve": dict(lanes=32, inflight_chunks=4, frames=48, qber_lo=0.05, qber_hi=0.08,
                        pool=4, blocks_per_s=40.0),
        "t_sweep": dict(warm_passes=1),
    }
    for name, real in STANDS_FOR.items():
        cell = spec.cell(real)
        cell = dict(cell, name=name, params=params[name], trace_slice_s=0.1,
                    config="tiny_alist" if name == "t_sweep" else "tiny_qc")
        (base / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return base


def bench_with_tiny() -> dict:
    """``BENCHMARK.json`` with each tiny cell reporting what its real cell does."""
    bench = spec.benchmark()
    for name, real in STANDS_FOR.items():
        bench["workloads"].append({"name": name, "chips": 1})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"] = m["workloads"] + [name]
    return bench


def run_tiny(base: Path, bench: dict, name: str, seed: int = 2**31 + 11, trace: int = 0,
             control: str | None = None, seconds: float = 0.5):
    argv = ["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)] + (["--control", control] if control else [])
    return run.run_cell(run.parse(argv), torch.device("cpu"), bench, base=base,
                        t_start=time.perf_counter())
