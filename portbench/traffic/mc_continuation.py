"""Traffic kind ``mc_continuation``: ``sim.continuation.run_point_continuation``
points back to back (the continuation program: staging, refills, banking),
with the loops' counts the program records after every call."""

from __future__ import annotations

from portbench import harness
from portbench.traffic._points import PointDriver, partials


class Driver(PointDriver):
    def __init__(self, ctx: harness.Context):
        self.opts = harness.decode_options(ctx)
        super().__init__(ctx)

    def call(self, key) -> dict:
        from qkd_ldpc_tpu_torch.sim import continuation

        p = self.ctx.params
        P, _ = continuation.run_point_continuation(
            self.code, key, p["qber"], p["trials"], p["batch"], self.opts,
            segment=p["segment"], refill_frac=p["refill_frac"], device=self.ctx.device)
        lane_passes = continuation.last_loop_counts["outer_steps"] * p["segment"] * p["batch"]
        return {"stats": partials(P), "lane_passes": lane_passes}
