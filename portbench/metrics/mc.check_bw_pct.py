"""The check update's share of its byte roofline (%): the bytes it needed
over the slice's points (``arith_check.check_bytes_per_frame_iteration`` a
frame-iteration; the frame-iterations are the points' statistics: the
successes' iteration sum and the cap for every trial that did not converge),
over the HBM peak and the device time of the check update's kernels in the
slice."""

from portbench import arith, arith_check, arith_secure


def read(run):
    units = run.units_in_slice()
    t = run.trace
    if t is None or not units:
        return None
    busy = arith.busy(arith_secure.kernel_intervals(t, *arith_check.CHECK_KERNELS), t.lo, t.hi)
    if busy <= 0:
        return None
    cfg, code = run.ctx.config, run.ctx.config["code"]
    cap = cfg["decoder"]["max_iterations"]
    per = arith_check.check_bytes_per_frame_iteration(
        code["n_vars"], code["n_checks"], code["n_edges"], run.ctx.storage)
    n = sum(arith.frame_iterations(u["stats"], cap) for u in units)
    return 100.0 * n * per / arith.HBM_BYTES_PER_S / busy
