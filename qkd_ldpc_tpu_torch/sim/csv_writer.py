"""CSV results writer with the reference's exact schema.

Counterpart of ``qkd_ldpc_tpu/sim/csv_writer.py``; its files are
byte-identical to the JAX package's for the same results.  Reproduces ``write_file`` (reference ``src/simulation.cpp:4-44``):
results directory auto-created; filename
``ldpc(trial_num=...,max_sum_prod_iters=...,seed=...).csv`` with ``_1, _2``
dedup suffixes; semicolon-separated header and rows; rate re-derived as
``1 - M/N``; ``FER = 1 - ratio_trials_successful_ldpc``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

from qkd_ldpc_tpu_torch.sim.stats import SimResult

CSV_HEADER = (
    "№;MATRIX_FILENAME;TYPE;CODE_RATE;M;N;QBER;"
    "ITERATIONS_SUCCESSFUL_SP_MEAN;ITERATIONS_SUCCESSFUL_SP_STD_DEV;"
    "ITERATIONS_SUCCESSFUL_SP_MIN;ITERATIONS_SUCCESSFUL_SP_MAX;"
    "RATIO_TRIALS_SUCCESSFUL_SP;RATIO_TRIALS_SUCCESSFUL_LDPC;FER"
)


def _fmt(x: float) -> str:
    """Format floats the way C++ ostream default does (up to 6 significant
    digits, no trailing zeros)."""
    if isinstance(x, bool):
        return str(int(x))
    if isinstance(x, int):
        return str(x)
    return f"{x:.6g}"


def results_file_path(
    directory: str | Path, trials_number: int, max_iterations: int, seed: int
) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    base = (
        f"ldpc(trial_num={trials_number},max_sum_prod_iters={max_iterations},"
        f"seed={seed})"
    )
    path = directory / f"{base}.csv"
    count = 1
    while path.exists():
        path = directory / f"{base}_{count}.csv"
        count += 1
    return path


def format_rows(results: Sequence[SimResult]) -> str:
    lines = [CSV_HEADER]
    for r in results:
        lines.append(
            ";".join(
                [
                    str(r.sim_number),
                    r.matrix_filename,
                    "regular" if r.is_regular else "irregular",
                    _fmt(r.code_rate),
                    str(r.num_check_nodes),
                    str(r.num_bit_nodes),
                    _fmt(r.initial_qber),
                    _fmt(r.iterations_successful_sp_mean),
                    _fmt(r.iterations_successful_sp_std_dev),
                    str(r.iterations_successful_sp_min),
                    str(r.iterations_successful_sp_max),
                    _fmt(r.ratio_trials_successful_sp),
                    _fmt(r.ratio_trials_successful_ldpc),
                    _fmt(r.fer),
                ]
            )
        )
    return "\n".join(lines) + "\n"


def write_results(
    results: Sequence[SimResult],
    directory: str | Path,
    trials_number: int,
    max_iterations: int,
    seed: int,
) -> Path:
    """Write the results CSV; returns the (dedup-suffixed) path."""
    path = results_file_path(directory, trials_number, max_iterations, seed)
    path.write_text(format_rows(results))
    return path
