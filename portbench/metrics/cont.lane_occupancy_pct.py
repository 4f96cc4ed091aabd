"""Frame-iterations the continuation's trials needed over the lane-passes
its program ran (%): outer steps (the program's recorded count after each
call) x passes a segment x lanes, over the window's points."""

from portbench import arith


def read(run):
    units = [u for u in run.units if u.get("lane_passes")]
    if not units:
        return None
    cap = run.ctx.config["decoder"]["max_iterations"]
    need = sum(arith.frame_iterations(u["stats"], cap) for u in units)
    return 100.0 * need / sum(u["lane_passes"] for u in units)
