"""Traffic kind ``mc_point_blocked``: ``mc_point``'s points and check, the
plain reference decoding ``batch`` trials at a time, so that its float32
``[dc, M, block]`` temporaries of a long frame fit the card beside the
program's state (at ``stats.point``'s default of 4,096 trials a block they
would not).  The reference decodes each trial on its own, so the block
width leaves its statistics as they are."""

from __future__ import annotations

import functools

from portbench.reference import stats
from portbench.traffic import mc_point


class Driver(mc_point.Driver):
    def check(self) -> list:
        point = stats.point
        stats.point = functools.partial(point, width=self.ctx.params["batch"])
        try:
            return super().check()
        finally:
            stats.point = point
