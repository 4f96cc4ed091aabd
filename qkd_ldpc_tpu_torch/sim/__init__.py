"""Monte-Carlo simulation: statistics and the point runner."""

from qkd_ldpc_tpu_torch.sim.runner import run_point
from qkd_ldpc_tpu_torch.sim.stats import (
    PointPartials,
    SimResult,
    finalize_point,
    reduce_trials,
)

__all__ = [
    "run_point",
    "PointPartials",
    "SimResult",
    "finalize_point",
    "reduce_trials",
]
