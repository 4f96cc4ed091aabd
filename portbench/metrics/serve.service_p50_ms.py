"""Median service time of a block: the benchmark's span around each
``Reconciler.reconcile`` call of the window (ms)."""

import statistics


def read(run):
    if not run.units:
        return None
    return 1e3 * statistics.median(u["t1"] - u["t0"] for u in run.units)
