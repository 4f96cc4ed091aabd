"""Configuration system.

Counterpart of ``qkd_ldpc_tpu/config.py``: the same fields, defaults,
validation messages and rate-table sorting, so one config file runs on both
packages.  JSON-compatible with the reference simulator's ``config.json``
schema (key names and validation semantics mirror ``src/config.cpp:4-115``
of the reference), extended with the framework's knobs (batch size, decoder
algorithm, dtype, checkpointing).  Unlike the reference's global mutable
``CFG`` (``src/config.hpp:65``), configuration here is an immutable
dataclass passed explicitly.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Sequence

_EPSILON = 1e-6  # step-sanity epsilon, as in reference config.cpp:96


@dataclasses.dataclass(frozen=True)
class RQBERParams:
    """One row of the code-rate -> QBER sweep table.

    Mirrors ``R_QBER_params`` (reference ``src/config.hpp:15-21``): the sweep
    planner picks the first entry (ascending by ``code_rate``) whose
    ``code_rate`` is >= the code's actual rate.
    """

    code_rate: float
    qber_begin: float
    qber_end: float
    qber_step: float

    def validate(self) -> None:
        # Mirrors reference config.cpp:82-101.
        if not (0.0 < self.code_rate < 1.0):
            raise ValueError("Code rate(R) must be: 0 < R < 1!")
        if (
            not (0.0 < self.qber_begin < 1.0)
            or not (0.0 < self.qber_end < 1.0)
            or self.qber_begin >= self.qber_end
        ):
            raise ValueError(
                "Invalid QBER begin or end parameters. QBER must be: "
                "0 < QBER < 1, and begin must be less than end."
            )
        if self.qber_step <= 0.0:
            raise ValueError("QBER step must be > 0!")
        if self.qber_step - _EPSILON > self.qber_end - self.qber_begin:
            raise ValueError("QBER step is too large.")


@dataclasses.dataclass(frozen=True)
class Config:
    """Full simulation configuration.

    Reference-compatible fields keep the semantics of ``config_data``
    (reference ``src/config.hpp:23-63``).  ``threads_number`` sizes the
    host thread pool for matrix ingest (``sim.runner.prepare_sim_inputs``)
    — trial parallelism itself is a device batch, not a thread
    pool, so the reference's trial-pool knob (simulation.cpp:230) maps to
    the remaining host-side concurrency.
    """

    # --- reference-compatible fields -------------------------------------
    threads_number: int = 1
    trials_number: int = 1000
    simulation_seed: int = 0
    interactive_mode: bool = False
    sum_product_max_iterations: int = 100
    use_dense_matrices: bool = False
    trace_qkd_ldpc: bool = False
    trace_sum_product: bool = False
    trace_sum_product_llr: bool = False
    enable_sum_product_msg_llr_threshold: bool = True
    sum_product_msg_llr_threshold: float = 100.0
    r_qber_parameters: tuple[RQBERParams, ...] = ()

    # --- framework extensions ----------------------------------------------
    decoder: str = "sum-product"  # "sum-product" | "min-sum"
    min_sum_alpha: float = 0.8  # normalization factor for min-sum
    min_sum_beta: float = 0.0  # offset min-sum (0 disables)
    batch_size: int = 0  # frames decoded per step; 0 = auto
    # QBER at/above which sweep points use continuation batching
    # (sim.continuation: converged lanes refill with fresh trials, so the
    # batch early-exit barrier stops taxing the waterfall's high iteration
    # variance).  0.0 disables; statistics are bit-identical either way —
    # this is purely a throughput crossover.
    continuation_qber: float = 0.0
    # The JAX package shards the trial grid over all visible devices when
    # this is set.  The port has no trial mesh yet: a sweep runs on one
    # device either way, and says so when more than one card is visible.
    use_mesh: bool = True
    dtype: str = "float32"  # message dtype on device
    backend: str = "auto"  # check-update kernel: "auto" | "xla" | "pallas"
    # Trial PRNG contract name (channel.keys determinism contract), kept
    # from the JAX package so one config runs on both.  In the port both
    # names give the portable threefry stream, bit for bit the JAX
    # package's "threefry" stream: on the card kernel K4
    # (channel/cuda_prng.py) makes it, on the CPU the plain key tree.  The
    # name is part of the experiment fingerprint, as in the JAX package.
    prng: str = "threefry"  # "threefry" | "pallas"
    # Decode-loop residency compaction (DecodeOptions.compact_*): after
    # this many iterations the unconverged minority of each batch is
    # gathered into batch/4 lanes and finished there (bit-identical
    # schedules — decoder/bp.py).  0 disables.
    compact_after: int = 0
    # Message-passing schedule (DecodeOptions.schedule): "flooding" is
    # the reference-parity two-phase schedule; "layered" is the serial
    # check-layered schedule for QC codes (~half the iterations at
    # equal-or-better FER; trajectories differ from the reference —
    # decoder/layered.py).
    schedule: str = "flooding"  # "flooding" | "layered"
    checkpoint_dir: str = ""  # "" disables sweep checkpointing
    results_dir: str = "results"
    matrix_dir: str = ""  # "" = use built-in discovery relative to cwd

    def validate(self) -> "Config":
        # Bounds checks mirror reference config.cpp:28-101.
        if self.threads_number < 1:
            raise ValueError("Number of threads must be >= 1!")
        if self.trials_number < 1:
            raise ValueError("Number of trials must be >= 1!")
        if self.sum_product_max_iterations < 1:
            raise ValueError(
                "Minimum number of sum-product iterations must be >= 1!"
            )
        if (
            self.enable_sum_product_msg_llr_threshold
            and self.sum_product_msg_llr_threshold <= 0.0
        ):
            raise ValueError("Sum-product message LLR threshold must be > 0!")
        if not self.r_qber_parameters:
            raise ValueError("Array with code rate and QBER parameters is empty!")
        for p in self.r_qber_parameters:
            p.validate()
        if self.decoder not in ("sum-product", "min-sum"):
            raise ValueError(f"Unknown decoder algorithm: {self.decoder!r}")
        if self.batch_size < 0:
            raise ValueError("batch_size must be >= 0 (0 = auto)")
        if not (0.0 <= self.continuation_qber < 1.0):
            raise ValueError(
                "continuation_qber must be in [0, 1) (0 disables)"
            )
        if self.dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"Unsupported message dtype: {self.dtype!r}")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"Unsupported decoder backend: {self.backend!r}")
        if self.prng not in ("threefry", "pallas"):
            raise ValueError(f"Unsupported prng implementation: {self.prng!r}")
        if self.compact_after < 0:
            raise ValueError("compact_after must be >= 0 (0 = off)")
        if self.schedule not in ("flooding", "layered"):
            raise ValueError(f"Unsupported schedule: {self.schedule!r}")
        if self.schedule == "layered" and self.continuation_qber > 0:
            # Continuation batching is built on the flooding loop's
            # _DecodeCore; silently mixing flooding (continuation
            # points) with layered (plain points) in one sweep would
            # make the CSV a chimera of two trajectory families.
            raise ValueError(
                "schedule='layered' does not compose with "
                "continuation_qber (set one or the other)"
            )
        # Sorted ascending by code rate, as in reference config.cpp:102-106.
        object.__setattr__(
            self,
            "r_qber_parameters",
            tuple(sorted(self.r_qber_parameters, key=lambda p: p.code_rate)),
        )
        return self


def _params_from_json(params: Sequence[dict[str, Any]]) -> tuple[RQBERParams, ...]:
    return tuple(
        RQBERParams(
            code_rate=float(p["code_rate"]),
            qber_begin=float(p["QBER_begin"]),
            qber_end=float(p["QBER_end"]),
            qber_step=float(p["QBER_step"]),
        )
        for p in params
    )


def config_from_dict(raw: dict[str, Any]) -> Config:
    """Build a :class:`Config` from a reference-schema JSON dict."""
    if not raw:
        raise ValueError("Configuration is empty")

    # Seed fallback to wall-clock time mirrors reference config.cpp:39-46.
    if raw.get("use_config_simulation_seed", True):
        seed = int(raw["simulation_seed"])
    else:
        seed = int(time.time())

    cfg = Config(
        threads_number=int(raw.get("threads_number", 1)),
        trials_number=int(raw["trials_number"]),
        simulation_seed=seed,
        interactive_mode=bool(raw.get("interactive_mode", False)),
        sum_product_max_iterations=int(raw["sum_product_max_iterations"]),
        use_dense_matrices=bool(raw.get("use_dense_matrices", False)),
        trace_qkd_ldpc=bool(raw.get("trace_qkd_ldpc", False)),
        trace_sum_product=bool(raw.get("trace_sum_product", False)),
        trace_sum_product_llr=bool(raw.get("trace_sum_product_llr", False)),
        # Default True, matching the Config dataclass default (a mismatch
        # here would let a config that merely omits the key silently
        # disable message clipping and change decode trajectories).
        enable_sum_product_msg_llr_threshold=bool(
            raw.get("enable_sum_product_msg_llr_threshold", True)
        ),
        sum_product_msg_llr_threshold=float(
            raw.get("sum_product_msg_llr_threshold", 100.0)
        ),
        r_qber_parameters=_params_from_json(raw["code_rate_QBER_parameters"]),
        decoder=str(raw.get("decoder", "sum-product")),
        min_sum_alpha=float(raw.get("min_sum_alpha", 0.8)),
        min_sum_beta=float(raw.get("min_sum_beta", 0.0)),
        batch_size=int(raw.get("batch_size", 0)),
        continuation_qber=float(raw.get("continuation_qber", 0.0)),
        use_mesh=bool(raw.get("use_mesh", True)),
        dtype=str(raw.get("dtype", "float32")),
        backend=str(raw.get("backend", "auto")),
        prng=str(raw.get("prng", "threefry")),
        compact_after=int(raw.get("compact_after", 0)),
        schedule=str(raw.get("schedule", "flooding")),
        checkpoint_dir=str(raw.get("checkpoint_dir", "")),
        results_dir=str(raw.get("results_dir", "results")),
        matrix_dir=str(raw.get("matrix_dir", "")),
    )
    return cfg.validate()


def load_config(path: str | Path) -> Config:
    """Load and validate a config JSON file (reference config.json schema)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Configuration file not found: {path}")
    text = path.read_text()
    if not text.strip():
        raise ValueError(f"Configuration file is empty: {path}")
    return config_from_dict(json.loads(text))
