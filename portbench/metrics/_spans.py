"""Readings of the program's own spans (the ``qkd.*`` ranges of
``qkd_ldpc_tpu_torch/spans.py``) in the traced slice, shared by the
per-layer metrics that read them.  A program without those spans leaves
every reading None."""

from __future__ import annotations

import bisect
import statistics

from portbench import arith


def in_slice(trace, *names) -> list[tuple[float, float]]:
    """``(start, end)`` of the host spans named ``names`` that lie whole
    inside the slice, in order of their starts."""
    return sorted((s, e) for s, e, n in trace.host
                  if n in names and trace.lo <= s and e <= trace.hi)


def covered(spans, s: float, e: float) -> float:
    """Seconds of ``[s, e]`` that ``spans`` (sorted by start) cover."""
    i = bisect.bisect_left(spans, (s,))
    j = bisect.bisect_right(spans, (e, float("inf")))
    return arith.busy(spans[i:j], s, e)


def host_and_wait_ms(run, outers: tuple, wait: str):
    """Medians over the slice's spans named ``outers`` of the span less the
    time its ``wait`` children cover, and of that time (ms); None where the
    slice holds no such span."""
    t = run.trace
    if t is None:
        return None
    outers = in_slice(t, *outers)
    if not outers:
        return None
    waits = in_slice(t, wait)
    w = [covered(waits, s, e) for s, e in outers]
    return (1e3 * statistics.median(e - s - x for (s, e), x in zip(outers, w)),
            1e3 * statistics.median(w))


def overlap(a, b) -> float:
    """Seconds two lists of disjoint intervals, each in order, share."""
    i = j = 0
    t = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            t += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return t


def idle_inside_pct(run, name: str):
    """Percent of the slice in which no device operation ran while the host
    was inside a span ``name``; None without a trace, a device operation or
    such a span in the slice."""
    t = run.trace
    if t is None or t.hi <= t.lo or not t.device:
        return None
    inside = arith.union([(s, e) for s, e, n in t.host if n == name], t.lo, t.hi)
    if not inside:
        return None
    idle = arith.gaps(t.device_intervals(), t.lo, t.hi)
    return 100.0 * overlap(idle, inside) / (t.hi - t.lo)
