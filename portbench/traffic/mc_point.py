"""Traffic kind ``mc_point``: ``sim.runner.run_point`` points back to back
(the flooding chunk, with residency compaction where the cell sets it)."""

from __future__ import annotations

from portbench import harness
from portbench.traffic._points import PointDriver, partials


class Driver(PointDriver):
    def __init__(self, ctx: harness.Context):
        p = ctx.params
        sched = {}
        if p.get("compact_after"):
            sched = dict(compact_after=p["compact_after"], compact_lanes=p["compact_lanes"])
        self.opts = harness.decode_options(ctx, **sched)
        super().__init__(ctx)

    def call(self, key) -> dict:
        from qkd_ldpc_tpu_torch.sim.runner import run_point

        p = self.ctx.params
        P, _ = run_point(self.code, key, p["qber"], p["trials"], p["batch"], self.opts,
                         max_batches_per_dispatch=p["max_batches_per_dispatch"],
                         device=self.ctx.device)
        return {"stats": partials(P)}
