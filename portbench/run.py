#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds (or loads from the checkout's build cache) the program's
kernels, makes the cell's code and inputs from the seed and warms up the
cell's own shapes; the window then measures for ``--seconds``.  With
``--trace 1`` the profiler runs from before set-up through a bounded slice
of the window and the per-layer metrics are reported; otherwise the
end-to-end metrics.  After the window the sampled answers are judged against
the plain reference in ``portbench/reference``; each number compared is
printed beside its limit, as the last lines on standard error and as the
last key of the result, the JSON object on the last line of standard output.

``--control <storage>`` runs the program with another message storage type
(the control of the correctness check); the benchmark's runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "qkd_ldpc_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``qkd_ldpc_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("float32", "bfloat16", "int8"), default=None)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed is a whole number >= 0 and --seconds a positive number")
    return args


def device_info(torch, device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def run_cell(args, device, bench: dict, base: Path | None = None, t_start: float = T_START):
    """One run of a cell on ``device``; returns ``(result, checks)``."""
    import torch

    from portbench import harness, spec
    from portbench.trace import Tracer

    base = base or harness.ROOT
    cell = spec.cell(args.workload, base)
    config = spec.config(cell["config"], base)
    ctx = harness.Context(cell=cell, config=config, seed=args.seed, device=device,
                          storage=args.control or config["decoder"]["storage"], base=base)
    tracer = Tracer(cell["trace_slice_s"]) if args.trace else None
    if tracer is not None:
        tracer.start()  # before set-up captures the program's graphs
    drv = spec.driver(cell["kind"], base)(ctx)
    window = harness.Window(args.seconds, tracer)
    drv.run(window)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    setup_s = window.t0 - t_start

    dev = device_info(torch, device, peak)
    metrics, breakdown = {}, None
    if tracer is None:
        measured = dict(drv.end_to_end(window), setup_s=setup_s)
        for m in spec.metrics_of(bench, "end_to_end", args.workload):
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    else:
        data = tracer.data()
        run = harness.Run(ctx=ctx, units=drv.units, trace=data, slice_end=tracer.host_end)
        for m in spec.metrics_of(bench, "per_layer", args.workload):
            v = spec.reader(m["name"], base)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if data is not None:
            dev["busy_s"] = data.busy_s()
            dev["window_s"] = data.hi - data.lo
            breakdown = {"device_ops": data.top_ops(), "idle_gaps": data.idle_gaps()}
        del data, run
        tracer = window.tracer = None
    attempted, failed = drv.attempted_failed()
    drv.release()
    harness.free_device_memory()
    t_check = time.perf_counter()
    checks = drv.check()
    print(f"portbench: the reference check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    correct = failed == 0 and all(v <= limit for _, v, limit in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import spec

    bench = spec.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: the cell needs {entry['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, checks = run_cell(args, torch.device("cuda", 0), bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}, which the benchmark must not "
              "import", file=sys.stderr)
        return 3
    for name, v, limit in checks:
        print(f"check {name} = {v!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
