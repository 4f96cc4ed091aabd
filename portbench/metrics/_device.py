"""Readings of the traced slice shared by the per-layer metrics."""

from __future__ import annotations

from portbench import arith


def idle_pct(run):
    """Percent of the traced slice in which no device operation ran: one
    minus the union of the device operations' intervals over the slice."""
    t = run.trace
    if t is None:
        return None
    return arith.idle_pct(t.device_intervals(), t.lo, t.hi)
