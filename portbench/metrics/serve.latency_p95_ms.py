"""95th percentile, over the blocks due and answered inside the traced
slice, of a block's answer time minus its due time (ms).  Measured under
the tracer; the blocks after the slice wait behind the profiler's stop and
are left out."""

from portbench import arith


def read(run):
    if run.slice_end is None:
        return None
    lat = [u["t1"] - u["due"] for u in run.units if "due" in u and u["t1"] <= run.slice_end]
    return 1e3 * arith.percentile(lat, 95) if lat else None
