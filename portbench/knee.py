#!/usr/bin/env python3
"""Find the highest block rate a serving cell sustains: one set-up, then
the cell's open loop at each rate of ``--rates`` for ``--seconds`` each,
and a closed loop (blocks back to back) for the service capacity.

    python3 portbench/knee.py --workload serve_qc_steady --seed 1 --seconds 8 \\
        --rates 60,80,100,110,120

A rate is sustained when no backlog stands or grows: every block due in
the window is answered, the median latency stays under four times the
closed loop's median service time, and the mean latency of the last tenth of
the blocks is at most that of the first tenth plus 5 ms.  One JSON line a rate
on standard output; the cell's fixed rate is four fifths of the highest
sustained one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="serve_qc_steady")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import arith, harness, spec

    if not torch.cuda.is_available():
        print("knee: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    ctx = harness.Context(cell=cell, config=config, seed=args.seed,
                          device=torch.device("cuda", 0), storage=config["decoder"]["storage"])
    drv = spec.driver(cell["kind"])(ctx)
    frames = cell["params"]["frames"]

    svc = []
    for i in range(200):
        b = i % cell["params"]["pool"]
        t = harness.now()
        drv.rec.reconcile(drv.bob[b], drv.syn[b], drv.qber[b])
        svc.append(harness.now() - t)
    service = statistics.median(svc)
    print(json.dumps({"closed_loop_blocks_per_s": len(svc) / sum(svc),
                      "service_p50_ms": 1e3 * statistics.median(svc),
                      "service_p95_ms": 1e3 * arith.percentile(svc, 95)}), flush=True)
    best = None
    for rate in (float(r) for r in args.rates.split(",")):
        ctx.params["blocks_per_s"] = rate
        window = harness.Window(args.seconds)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
