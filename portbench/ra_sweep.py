#!/usr/bin/env python3
"""Set-up readings of the rate-adaptive secure cell on the card.

    python3 portbench/ra_sweep.py efficiency --seed 1
    python3 portbench/ra_sweep.py knee --seed 1 --seconds 8 --rates 20,30,40 \\
        [--efficiency F]

``efficiency``: for each f of 1.25, 1.30, ..., 1.50 (the configuration's
``efficiency`` replaced), one pass of the cell's pool, each block once through
the endpoint: the frame-error rate (frames not verified) over the pool and,
for each rate step the pool reaches, its blocks, frames, FER and mean
iterations, the serve captures over the pass; then the lowest f whose FER is
at most 10 % (1.50 where none is).

``knee``: ``knee.py``'s rule with the secure block as the unit: a closed
loop of blocks back to back for the service time, then the cell's open loop
at each rate of ``--rates``; a rate is sustained when every block due is
answered, the median latency stays under four times the closed loop's median
service and the last tenth's mean latency is at most the first tenth's plus
5 ms (``--rates auto``: 0.5 to 1.0 of the closed loop's rate).  The cell's
rate is four fifths of the highest sustained one.

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WORKLOAD = "serve_ra_secure_drift"
EFFICIENCIES = (1.25, 1.30, 1.35, 1.40, 1.45, 1.50)
FER_TARGET = 0.10
AUTO_SHARES = (0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 1.0)  # --rates auto


def driver(seed: int, efficiency: float | None):
    import torch

    from portbench import harness, spec

    cell = spec.cell(WORKLOAD)
    config = copy.deepcopy(spec.config(cell["config"]))
    if efficiency is not None:
        config["rate_adaptation"]["efficiency"] = efficiency
    ctx = harness.Context(cell=cell, config=config, seed=seed, device=torch.device("cuda", 0),
                          storage=config["decoder"]["storage"])
    return spec.driver(cell["kind"])(ctx)


def efficiency_sweep(seed: int) -> None:
    import numpy as np

    from qkd_ldpc_tpu_torch.decoder import device_loop

    chosen = None
    for f in EFFICIENCIES:
        captures = [0]
        real = device_loop.Graph.capture

        def counted(graph, *a, **kw):
            captures[0] += 1
            return real(graph, *a, **kw)

        device_loop.Graph.capture = counted
        try:
            drv = driver(seed, f)
            at_setup = captures[0]
            pool = drv.ctx.params["pool"]
            drv.prepare({i: i for i in range(pool)})
            steps, rows = {}, []
            for b in range(pool):
                out = drv.one_block(b)
                s = drv.family.step(drv.qber[b], f)
                rows.append((s, out.verified, out.iterations))
        finally:
            device_loop.Graph.capture = real
        frames = sum(v.size for _, v, _ in rows)
        fer = 1.0 - sum(int(v.sum()) for _, v, _ in rows) / frames
        for s, v, it in rows:
            e = steps.setdefault(s, {"blocks": 0, "frames": 0, "errors": 0, "iterations": 0})
            e["blocks"] += 1
            e["frames"] += v.size
            e["errors"] += int((~v).sum())
            e["iterations"] += int(it.sum())
        per_step = {s: {"p": s * drv.ra["grid"], "blocks": e["blocks"], "frames": e["frames"],
                        "fer": e["errors"] / e["frames"],
                        "mean_iterations": e["iterations"] / e["frames"],
                        "qbers": sorted({drv.qber[b] for b in range(pool)
                                         if drv.family.step(drv.qber[b], f) == s})}
                    for s, e in sorted(steps.items())}
        print(json.dumps({"efficiency": f, "fer": fer, "frames": frames,
                          "captures_in_setup": at_setup,
                          "captures_in_pass": captures[0] - at_setup,
                          "serve_programs": sum(k[0] == "serve" for k in drv.rec._runners),
                          "mean_iterations": float(np.mean([it.mean() for _, _, it in rows])),
                          "steps": per_step}), flush=True)
        if chosen is None and fer <= FER_TARGET:
            chosen = f
        drv.release()
        del drv
    print(json.dumps({"chosen_efficiency": chosen if chosen is not None else EFFICIENCIES[-1],
                      "any_at_target": chosen is not None}), flush=True)


def knee(seed: int, seconds: float, rates: str, efficiency: float | None) -> None:
    import torch

    from portbench import arith, harness

    drv = driver(seed, efficiency)
    frames = drv.ctx.params["frames"]
    drv.prepare({i: i % drv.ctx.params["pool"] for i in range(200)})
    svc = []
    for i in range(200):
        t = harness.now()
        drv.one_block(i)
        svc.append(harness.now() - t)
    service = statistics.median(svc)
    print(json.dumps({"closed_loop_blocks_per_s": len(svc) / sum(svc),
                      "service_p50_ms": 1e3 * service,
                      "service_p95_ms": 1e3 * arith.percentile(svc, 95)}), flush=True)
    closed = len(svc) / sum(svc)
    if rates == "auto":  # shares of the closed loop's rate
        rates = ",".join(f"{closed * x:.1f}" for x in AUTO_SHARES)
    best = None
    for rate in (float(r) for r in rates.split(",")):
        drv.ctx.params["blocks_per_s"] = rate
        window = harness.Window(seconds)
        drv.run(window)
        lat = [(u["t1"] - u["due"]) * 1e3 for u in drv.units]
        tenth = max(1, len(lat) // 10)
        first, last = statistics.mean(lat[:tenth]), statistics.mean(lat[-tenth:])
        ok = (len(drv.units) == drv.n_due and statistics.median(lat) < 4e3 * service
              and last <= first + 5.0)
        best = rate if ok else best
        print(json.dumps({"blocks_per_s": rate, "sustained": ok, "blocks": len(lat),
                          "frames_per_s": len(lat) * frames / window.length,
                          "latency_p50_ms": statistics.median(lat),
                          "latency_p95_ms": arith.percentile(lat, 95),
                          "first_tenth_ms": first, "last_tenth_ms": last}), flush=True)
    print(json.dumps({"highest_sustained_blocks_per_s": best,
                      "cell_rate": None if best is None else 0.8 * best,
                      "device": torch.cuda.get_device_name(0)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("efficiency", "knee"))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--efficiency", type=float, default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ra_sweep: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    if args.what == "efficiency":
        efficiency_sweep(args.seed)
    else:
        knee(args.seed, args.seconds, args.rates, args.efficiency)
    return 0


if __name__ == "__main__":
    sys.exit(main())
