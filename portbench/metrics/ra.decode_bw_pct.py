"""Bytes the decode of the slice's blocks needed, over the HBM peak and the
device time of the flooding decode's kernels (K1, K2, KV: the
``check_update`` and ``variable_update`` kernels) in the slice (%).

The frame-iterations are the endpoint's own counter (a frame's iterations,
the cap for a frame that did not converge), read after each block; per
frame-iteration the bytes are ``arith.decode_bytes_per_frame_iteration``'s,
each counted once whatever implements them."""

from portbench import arith, arith_secure


def read(run):
    units = [u for u in run.units_in_slice() if "frame_iterations" in u]
    if run.trace is None or not units:
        return None
    t = run.trace
    busy = arith.busy(arith_secure.kernel_intervals(t, "check_update", "variable_update"),
                      t.lo, t.hi)
    if busy <= 0:
        return None
    code = run.ctx.config["code"]
    per = arith.decode_bytes_per_frame_iteration(code["n_vars"], code["n_edges"],
                                                 run.ctx.storage)
    n = sum(u["frame_iterations"] for u in units)
    return 100.0 * n * per / arith.HBM_BYTES_PER_S / busy
