"""Interactive simulation mode.

Counterpart of ``qkd_ldpc_tpu/sim/interactive.py`` and, like it, of
``QKD_LDPC_interactive_simulation`` (reference ``src/simulation.cpp:73-137``):
the user picks one matrix file from a numbered console menu, then one trial
runs per QBER sweep point with per-point prints of the actual QBER, the
error count, iterations, and the reconciliation verdict.  The untraced
decode is one trial at B = 1 through the device path; with a trace flag on,
the frame decodes on the host float64 oracle instead.
"""

from __future__ import annotations

import builtins
from pathlib import Path
from typing import Sequence

from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.codes import list_matrix_files, load_code
from qkd_ldpc_tpu_torch.config import Config
from qkd_ldpc_tpu_torch.decoder.reconcile import reconcile
from qkd_ldpc_tpu_torch.sim.planner import rate_based_qber_range
from qkd_ldpc_tpu_torch.sim.runner import decode_options_from_config
from qkd_ldpc_tpu_torch.sim.tracing import TraceFlags, traced_reconcile
from qkd_ldpc_tpu_torch.utils import resolve_device


def select_matrix_file(paths: Sequence[Path], input_fn=None, print_fn=print) -> Path:
    """Numbered console menu (reference ``select_matrix_file``,
    ``src/utils.cpp:50-66``)."""
    if input_fn is None:  # resolve at call time so tests can monkeypatch
        input_fn = builtins.input
    print_fn("Matrix files:")
    for i, p in enumerate(paths):
        print_fn(f"{i + 1}. {p.name}")
    while True:
        try:
            choice = int(input_fn("Select a matrix file: "))
            if 1 <= choice <= len(paths):
                return paths[choice - 1]
        except ValueError:
            pass  # EOFError propagates: closed stdin must not spin forever
        print_fn("Invalid selection. Try again.")


def interactive_simulation(
    cfg: Config, matrix_dir: str | Path, input_fn=None, print_fn=print, device=None
) -> None:
    """``device=None`` means the card and raises when there is none."""
    device = resolve_device(device)
    paths = list_matrix_files(matrix_dir)
    if not paths:
        raise FileNotFoundError(f"Matrix folder is empty: {matrix_dir}")
    matrix_path = select_matrix_file(paths, input_fn, print_fn)
    code = load_code(matrix_path, dense=cfg.use_dense_matrices)
    print_fn(f"Matrix H is {'regular' if code.is_regular else 'irregular'}.")

    opts = decode_options_from_config(cfg)
    qber_range = rate_based_qber_range(code.code_rate, cfg.r_qber_parameters)
    # The JAX package's interactive mode keys its points off PRNGKey(seed)
    # itself (the sweep folds a master key); the same here.
    master = prng_key(cfg.simulation_seed)
    flags = TraceFlags.from_config(cfg)

    for i, qber in enumerate(qber_range):
        print_fn(f"№:{i + 1}")
        n_err = num_errors_for(code.n_vars, qber)
        if n_err == 0:
            raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
        actual_qber = n_err / code.n_vars
        print_fn(f"Actual QBER: {actual_qber}")

        point_key = fold_in(master, i)
        alice, bob = make_trial_batch(point_key, code.n_vars, 1, n_err,
                                      backend=opts.backend, device=device)
        n_diff = int((alice ^ bob).sum())
        print_fn(f"Number of errors in a key: {n_diff}")

        if flags.any:
            # Traced decode runs on the host f64 oracle — the device path
            # never contains trace prints.
            ores, okeys = traced_reconcile(
                code,
                alice[0].cpu().numpy(),
                bob[0].cpu().numpy(),
                actual_qber,
                max_iterations=opts.max_iterations,
                clip_messages=opts.clip_messages,
                message_threshold=opts.message_threshold,
                flags=flags,
                print_fn=print_fn,
            )
            ok = bool(ores.syndromes_match) and okeys
            iters = ores.iterations
        else:
            res = reconcile(code, alice, bob, actual_qber, opts, device)
            ok = bool(res.syndromes_match[0]) and bool(res.keys_match[0])
            iters = int(res.iterations[0])
        print_fn(f"Iterations performed: {iters}")
        print_fn(
            "Error reconciliation SUCCESSFUL" if ok else "Error reconciliation FAILED"
        )
        print_fn("")
