"""Traffic kind ``mc_point_layered``: ``sim.runner.run_point`` points back
to back under the layered schedule (the layered chunk: K6 sweeps, with
residency compaction where the cell sets it), held against the plain
layered reference (``reference/layered.py``)."""

from __future__ import annotations

import random

from portbench import harness
from portbench.reference import channel, codes, layered, stats
from portbench.traffic._points import PointDriver, partials


class Driver(PointDriver):
    def __init__(self, ctx: harness.Context):
        p = ctx.params
        sched = {"schedule": "layered"}
        if p.get("compact_after"):
            sched.update(compact_after=p["compact_after"], compact_lanes=p["compact_lanes"])
        self.opts = harness.decode_options(ctx, **sched)
        super().__init__(ctx)

    def call(self, key) -> dict:
        from qkd_ldpc_tpu_torch.sim.runner import run_point

        p = self.ctx.params
        P, _ = run_point(self.code, key, p["qber"], p["trials"], p["batch"], self.opts,
                         max_batches_per_dispatch=p["max_batches_per_dispatch"],
                         device=self.ctx.device)
        return {"stats": partials(P)}

    def check(self) -> list:
        """``stats_gap``: the largest relative gap, over the sampled points
        and their statistics, between the program's and the layered
        reference's."""
        p, ctx = self.ctx.params, self.ctx
        sample = random.Random(ctx.seed).sample(
            self.units, min(ctx.cell["check"]["points"], len(self.units)))
        host = codes.build(ctx.config["code"], ctx.base / "configs")
        g = codes.on_device(host, ctx.device)
        lay = layered.Layers(host, ctx.config["code"]["z"], ctx.device)
        dec = harness.reference_decoder(ctx)
        n_err = channel.num_errors(g.n_vars, p["qber"])
        gap = 0.0 if sample else float("inf")
        for u in sample:
            ref = layered.point(dec, lay, g, ctx.key(u["index"]), n_err, p["trials"])
            got = u["stats"]
            keys = stats.KEYS[:5] + (stats.KEYS[5:] if ref["n_sp"] and got["n_sp"] else ())
            gap = max([gap] + [stats.relative_gap(got[k], ref[k]) for k in keys])
        return [("stats_gap", gap, ctx.cell["check"]["limits"]["stats_gap"])]
