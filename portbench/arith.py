"""The benchmark's yardstick arithmetic: device intervals, busy and idle
time in a traced slice, the bytes a decode needs, and the card's peak.

Times are in seconds on one timeline; an interval is ``(start, end)``.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12

STORAGE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as disjoint
    intervals in order."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` in which some interval is open."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of ``[lo, hi]`` between the union's pieces."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out


def idle_pct(intervals, lo: float, hi: float) -> float | None:
    """Percent of ``[lo, hi]`` with no device operation running, or None
    where the slice is empty or holds no device operation at all."""
    if hi <= lo or not intervals:
        return None
    b = busy(intervals, lo, hi)
    return None if b <= 0 else 100.0 * (1.0 - b / (hi - lo))


def decode_bytes_per_frame_iteration(n_vars: int, n_edges: int, storage: str) -> int:
    """Bytes one flooding iteration of one frame needs, each counted once:
    every edge message read and written at the storage width, the frame's
    float32 channel LLRs read, its totals (storage width) and its hard
    decisions (one byte each) written."""
    w = STORAGE_BYTES[storage]
    return 2 * n_edges * w + 4 * n_vars + w * n_vars + n_vars


def frame_iterations(stats: dict, max_iterations: int) -> int:
    """Iterations a point's trials needed: the successes' sum, and the cap
    for every trial that did not converge."""
    return stats["sum_it"] + (stats["n_trials"] - stats["n_sp"]) * max_iterations


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (nearest rank) of ``values``."""
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(-(-p * len(xs) // 100)) - 1))
    return xs[k]
