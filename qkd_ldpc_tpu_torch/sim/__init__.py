"""Monte-Carlo simulation: sweep planning, the point, continuation and sweep
runners, statistics, CSV output, interactive mode and console tracing."""

from qkd_ldpc_tpu_torch.sim.continuation import (
    dispatch_sweep_continuation,
    run_point_continuation,
)
from qkd_ldpc_tpu_torch.sim.csv_writer import (
    CSV_HEADER,
    format_rows,
    results_file_path,
    write_results,
)
from qkd_ldpc_tpu_torch.sim.interactive import interactive_simulation, select_matrix_file
from qkd_ldpc_tpu_torch.sim.planner import rate_based_qber_range
from qkd_ldpc_tpu_torch.sim.runner import (
    SimInput,
    auto_batch_size,
    batch_simulation,
    decode_options_from_config,
    prepare_sim_inputs,
    run_point,
    simulate_directory,
)
from qkd_ldpc_tpu_torch.sim.stats import (
    PointPartials,
    SimResult,
    finalize_point,
    partials_from_device,
    reduce_trials,
)
from qkd_ldpc_tpu_torch.sim.tracing import ConsoleTracer, TraceFlags, traced_reconcile

__all__ = [
    "CSV_HEADER",
    "format_rows",
    "results_file_path",
    "write_results",
    "interactive_simulation",
    "ConsoleTracer",
    "TraceFlags",
    "traced_reconcile",
    "select_matrix_file",
    "rate_based_qber_range",
    "SimInput",
    "auto_batch_size",
    "batch_simulation",
    "decode_options_from_config",
    "prepare_sim_inputs",
    "run_point",
    "run_point_continuation",
    "dispatch_sweep_continuation",
    "simulate_directory",
    "PointPartials",
    "SimResult",
    "finalize_point",
    "partials_from_device",
    "reduce_trials",
]
