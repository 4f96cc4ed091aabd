"""Monte-Carlo simulation: statistics, the point runner and the
continuation runner."""

from qkd_ldpc_tpu_torch.sim.continuation import (
    dispatch_sweep_continuation,
    run_point_continuation,
)
from qkd_ldpc_tpu_torch.sim.runner import run_point
from qkd_ldpc_tpu_torch.sim.stats import (
    PointPartials,
    SimResult,
    finalize_point,
    reduce_trials,
)

__all__ = [
    "run_point",
    "run_point_continuation",
    "dispatch_sweep_continuation",
    "PointPartials",
    "SimResult",
    "finalize_point",
    "reduce_trials",
]
