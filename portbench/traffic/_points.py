"""Monte-Carlo points back to back: the shared driver of the point runners.

Every point has ``trials`` trials at one QBER and a fresh point key, derived
from the run's seed and the point's index; the window closes at the first
point completed after ``--seconds``.  A sample of the window's points,
drawn from the seed, is decoded again by the plain reference."""

from __future__ import annotations

import dataclasses
import random

from portbench import harness
from portbench.reference import channel, stats

WARM = 0xFFFFFFFF  # the warm-up points' unit indices count down from here


class PointDriver:
    """A traffic kind whose unit is one point through :meth:`call`."""

    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        self.code = harness.program_code(ctx)
        self.units: list[dict] = []
        self.spans: list = []
        for w in range(ctx.params.get("warm_points", 2)):
            self.call(ctx.key(WARM - w))

    def call(self, key) -> dict:
        """One point; returns its statistics (and any counters)."""
        raise NotImplementedError

    def run(self, window: harness.Window) -> None:
        i = 0
        window.open()
        while not window.closed:
            key = self.ctx.key(i)
            with harness.span("portbench.point", self.spans):
                out = self.call(key)
            t0, t1 = self.spans[-1]
            self.units.append(dict(index=i, t0=t0, t1=t1, **out))
            window.unit_done(t1)
            i += 1

    def end_to_end(self, window: harness.Window) -> dict:
        trials = sum(u["stats"]["n_trials"] for u in self.units)
        return {"trials_per_s": trials / window.length}

    def attempted_failed(self) -> tuple[int, int]:
        return len(self.units), 0

    def release(self) -> None:
        self.code = None

    def check(self) -> list:
        """``stats_gap``: the largest relative gap, over the sampled points
        and their statistics, between the program's and the reference's."""
        p, ctx = self.ctx.params, self.ctx
        rng = random.Random(ctx.seed)
        sample = rng.sample(self.units, min(ctx.cell["check"]["points"], len(self.units)))
        g = harness.reference_graph(ctx)
        dec = harness.reference_decoder(ctx)
        n_err = channel.num_errors(g.n_vars, p["qber"])
        gap = 0.0
        for u in sample:
            ref = stats.point(dec, g, ctx.key(u["index"]), n_err, p["trials"])
            got = u["stats"]
            keys = stats.KEYS[:5] + (stats.KEYS[5:] if ref["n_sp"] and got["n_sp"] else ())
            gap = max([gap] + [stats.relative_gap(got[k], ref[k]) for k in keys])
        if not sample:
            gap = float("inf")
        return [("stats_gap", gap, ctx.cell["check"]["limits"]["stats_gap"])]


def partials(P) -> dict:
    """The program's point statistics as a dict of the reference's keys."""
    d = dataclasses.asdict(P)
    return {k: d[k] for k in stats.KEYS}
