"""K6's share of its byte roofline (%): the bytes the layered decode of the
slice's points needed (``arith.decode_bytes_per_frame_iteration`` a sweep of
a frame; the sweeps are the points' statistics: the successes' iteration
sum and the cap for every trial that did not converge), over the HBM peak
and the device time of the layered sweep kernel (``layered_sweep``) in the
slice."""

from portbench import arith, arith_secure


def read(run):
    units = run.units_in_slice()
    t = run.trace
    if t is None or not units:
        return None
    busy = arith.busy(arith_secure.kernel_intervals(t, "layered_sweep"), t.lo, t.hi)
    if busy <= 0:
        return None
    cfg, code = run.ctx.config, run.ctx.config["code"]
    cap = cfg["decoder"]["max_iterations"]
    per = arith.decode_bytes_per_frame_iteration(code["n_vars"], code["n_edges"],
                                                 run.ctx.storage)
    n = sum(arith.frame_iterations(u["stats"], cap) for u in units)
    return 100.0 * n * per / arith.HBM_BYTES_PER_S / busy
