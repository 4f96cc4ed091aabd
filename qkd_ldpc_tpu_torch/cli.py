"""Command-line entry point.

Counterpart of ``qkd_ldpc_tpu/cli.py`` and, like it, of the reference's
``main()`` (``src/main.cpp:15-68``), which takes no arguments and hard-codes
every path at compile time: this CLI keeps its behavior (config JSON ->
batch or interactive mode over a matrix directory -> CSV) but makes paths
proper arguments.  ``--device`` chooses where the sweep runs: the card by
default (an error without one), ``cpu`` for the plain PyTorch versions.
``--coordinator HOST:PORT --num-processes N --process-id I`` joins a group
of N processes (gloo over ``torch.distributed``) before any device work; the
sweep then shards its trials over every process, and only process 0 writes
the CSV and the checkpoint.

Usage:
    python -m qkd_ldpc_tpu_torch --config config.json [--matrix-dir DIR]
                                 [--results-dir DIR] [--interactive]
                                 [--device cpu]
                                 [--coordinator HOST:PORT --num-processes N
                                  --process-id I]
    python -m qkd_ldpc_tpu_torch generate --n 10240 --m 5231 --dv 3 --seed 666 -o out.alist
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

from qkd_ldpc_tpu_torch.utils import print_error, print_mode, print_status

MULTI_PROCESS_FLAGS = (
    "a multi-process run needs all three of --coordinator HOST:PORT, "
    "--num-processes N and --process-id I"
)


def _default_matrix_dir(cfg, base: Path) -> Path:
    # Mirrors the reference's directory dispatch (main.cpp:23).
    sub = "dense_matrices" if cfg.use_dense_matrices else "alist_sparse_matrices"
    return base / sub


@contextlib.contextmanager
def _profile(directory: str):
    """A ``torch.profiler`` trace of the block, written to ``directory`` as a
    Chrome trace when it ends (nothing when ``directory`` is empty)."""
    if not directory:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(directory).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(directory) / "sweep.pt.trace.json"))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="qkd_ldpc_tpu_torch",
        description="QKD LDPC error-reconciliation simulator (PyTorch/CUDA)",
    )
    sub = parser.add_subparsers(dest="command")

    run = sub.add_parser("run", help="run a simulation sweep (default)")
    for p in (parser, run):
        p.add_argument("--config", default="config.json", help="config JSON path")
        p.add_argument("--matrix-dir", default="", help="matrix directory")
        p.add_argument("--results-dir", default="", help="results directory")
        p.add_argument(
            "--interactive", action="store_true", help="interactive mode"
        )
        p.add_argument("--no-progress", action="store_true")
        p.add_argument(
            "--device", default=None,
            help="torch device of the sweep (default: the CUDA card, an "
            "error without one; 'cpu' runs the plain PyTorch versions)",
        )
        p.add_argument(
            "--profile",
            metavar="DIR",
            default="",
            help="write a torch.profiler trace of the sweep to DIR "
            "(Chrome trace format)",
        )
        p.add_argument(
            "--coordinator", default="",
            help="HOST:PORT of process 0's rendezvous for a multi-process run",
        )
        p.add_argument("--num-processes", type=int, default=0,
                       help="processes of a multi-process run")
        p.add_argument("--process-id", type=int, default=-1,
                       help="this process's rank in a multi-process run")

    gen = sub.add_parser("generate", help="generate a random LDPC code")
    gen.add_argument("--n", type=int, required=True)
    gen.add_argument("--m", type=int, required=True)
    gen.add_argument("--dv", type=int, default=3)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("-o", "--output", required=True)
    gen.add_argument("--dense", action="store_true", help="write dense format")
    gen.add_argument(
        "--qc", type=int, default=0, metavar="Z",
        help="build a girth>=6 quasi-cyclic code with lift size Z "
        "(n, m must be multiples of Z)",
    )

    args = parser.parse_args(argv)

    if args.command == "generate":
        from qkd_ldpc_tpu_torch.codes import (
            make_code,
            make_qc_code,
            write_alist,
            write_dense,
        )

        if args.qc:
            z = args.qc
            if args.n % z or args.m % z:
                print_error(f"ERROR: n and m must be multiples of Z={z}")
                return 1
            code = make_qc_code(z=z, nb=args.n // z, mb=args.m // z,
                                dv=args.dv, seed=args.seed)
        else:
            code = make_code(n=args.n, m=args.m, dv=args.dv, seed=args.seed)
        (write_dense if args.dense else write_alist)(code, args.output)
        print(f"Wrote {code} -> {args.output}")
        return 0

    from qkd_ldpc_tpu_torch.parallel.mesh import shutdown_distributed

    try:
        return _run(args)
    except Exception as e:  # match reference main()'s catch-all exit(1)
        print_error(f"ERROR: {e}")
        return 1
    finally:
        shutdown_distributed()


def _run(args) -> int:
    from qkd_ldpc_tpu_torch.config import load_config
    from qkd_ldpc_tpu_torch.parallel.mesh import initialize_distributed, process_index
    from qkd_ldpc_tpu_torch.utils import resolve_device

    given = (bool(args.coordinator), args.num_processes > 0, args.process_id >= 0)
    if any(given) and not all(given):
        # torch.distributed discovers no cluster: an incomplete set would run
        # the whole sweep alone in this process.
        raise ValueError(MULTI_PROCESS_FLAGS)
    if args.coordinator:
        # Before any device work, as the JAX CLI brings up jax.distributed.
        initialize_distributed(args.coordinator, args.num_processes, args.process_id)
    is_coord = process_index() == 0
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    base = Path(args.config).resolve().parent
    # Paths from the CONFIG FILE resolve against the config's directory
    # (like the reference's SOURCE_DIR-rooted paths, main.cpp:8); paths
    # from CLI flags resolve against the CWD as users expect.
    if args.matrix_dir:
        matrix_dir = Path(args.matrix_dir)
    else:
        matrix_dir = Path(cfg.matrix_dir) if cfg.matrix_dir else _default_matrix_dir(cfg, base)
        if not matrix_dir.is_absolute():
            matrix_dir = base / matrix_dir
    if args.results_dir:
        results_dir = Path(args.results_dir)
    else:
        results_dir = Path(cfg.results_dir)
        if not results_dir.is_absolute():
            results_dir = base / results_dir

    if args.interactive or cfg.interactive_mode:
        print_mode("INTERACTIVE MODE")
        from qkd_ldpc_tpu_torch.sim import interactive_simulation

        interactive_simulation(cfg, matrix_dir, device=device)
        return 0
    if is_coord:
        print_mode("BATCH MODE")
    from qkd_ldpc_tpu_torch.sim import simulate_directory, write_results

    with _profile(args.profile):
        results = simulate_directory(
            cfg, matrix_dir, progress=not args.no_progress and is_coord, device=device,
        )
    # Rank-aware output: every process computes (the collectives need it),
    # process 0 alone writes the durable artifacts.
    if is_coord:
        path = write_results(
            results,
            results_dir,
            cfg.trials_number,
            cfg.sum_product_max_iterations,
            cfg.simulation_seed,
        )
        print_status(f"The results have been written to: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
