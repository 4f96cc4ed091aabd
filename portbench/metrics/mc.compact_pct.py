"""Share of the device's busy time in the slice spent moving lanes for
residency compaction (%): the kernels ``compact_partition``,
``compact_gather`` and ``compact_scatter``."""

from portbench import arith, arith_secure

KERNELS = ("compact_partition", "compact_gather", "compact_scatter")


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = t.busy_s()
    if busy <= 0:
        return None
    return 100.0 * arith.busy(arith_secure.kernel_intervals(t, *KERNELS), t.lo, t.hi) / busy
