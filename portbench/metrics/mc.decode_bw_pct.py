"""Bytes the decode of the slice's points needed, over the HBM peak and the
device's busy time in the slice (%).

Per frame-iteration the bytes are counted once each, whatever implements
them (``arith.decode_bytes_per_frame_iteration``); the frame-iterations are
those the points' returned statistics give: the successes' iteration sum and
the cap for every trial that did not converge."""

from portbench import arith


def read(run):
    units = run.units_in_slice()
    if run.trace is None or not units:
        return None
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    cfg, code = run.ctx.config, run.ctx.config["code"]
    cap = cfg["decoder"]["max_iterations"]
    per = arith.decode_bytes_per_frame_iteration(code["n_vars"], code["n_edges"],
                                                 run.ctx.storage)
    n = sum(arith.frame_iterations(u["stats"], cap) for u in units)
    return 100.0 * n * per / arith.HBM_BYTES_PER_S / busy
