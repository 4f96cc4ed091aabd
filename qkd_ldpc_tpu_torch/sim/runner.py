"""The Monte-Carlo trial step and the point runner.

Counterpart of ``qkd_ldpc_tpu/sim/runner.py`` for one (matrix, QBER) point:
key generation, exact-weight error injection, syndrome computation,
batched BP decode and the statistics reduction, batch after batch, with
seven int32 scalars per chunk as the only result fetched from the device.
(The decode loop itself fetches one flag per iteration.)  Sweep
orchestration over many points, checkpointing and the CLI are not part of
this slice of the port.

Determinism contract: trial t of a point uses ``fold_in(point_key, t)`` —
reproducible independent of the batch size.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.decoder.reconcile import reconcile
from qkd_ldpc_tpu_torch.sim.stats import (
    PointPartials,
    partials_from_stacked,
    reduce_trials,
    stack_partials,
)
from qkd_ldpc_tpu_torch.utils import resolve_device


def point_batch_partials(
    code: LDPCCode,
    point_key: torch.Tensor,
    num_errors: int,
    trial_offset: int,
    valid_count: int,
    batch: int,
    opts: DecodeOptions,
    prng: str = "threefry",
    device=None,
) -> dict[str, torch.Tensor]:
    """One device step: trials [offset, offset+batch) -> partial sums."""
    device = resolve_device(device)
    alice, bob = make_trial_batch(
        point_key, code.n_vars, batch, num_errors, trial_offset, prng,
        opts.backend, device,
    )
    # float32 division, as the JAX step computes the QBER it decodes with.
    actual_qber = np.float32(num_errors) / np.float32(code.n_vars)
    res = reconcile(code, alice, bob, actual_qber, opts, device)
    valid = torch.arange(batch, dtype=torch.int32, device=device) < valid_count
    return reduce_trials(
        res.syndromes_match, res.keys_match, res.iterations,
        opts.max_iterations, valid,
    )


def merge_partials_tree(a: dict, b: dict) -> dict:
    """Device-side merge of two partial-sum dicts (min/max-aware)."""
    return dict(
        n_trials=a["n_trials"] + b["n_trials"],
        n_sp=a["n_sp"] + b["n_sp"],
        n_ldpc=a["n_ldpc"] + b["n_ldpc"],
        sum_it=a["sum_it"] + b["sum_it"],
        sum_it2=a["sum_it2"] + b["sum_it2"],
        min_it=torch.minimum(a["min_it"], b["min_it"]),
        max_it=torch.maximum(a["max_it"], b["max_it"]),
    )


def _point_chunk(code, point_key, num_errors, start_offset, total_valid,
                 batch, n_batches, opts, prng="threefry", device=None):
    """``n_batches`` sequential trial batches merged on the device: one
    result fetch per chunk instead of per batch.  The tail batch masks its
    excess trials through ``valid_count``."""
    out = None
    for i in range(n_batches):
        valid = min(max(total_valid - i * batch, 0), batch)
        red = point_batch_partials(
            code, point_key, num_errors, start_offset + i * batch, valid,
            batch, opts, prng, device,
        )
        out = red if out is None else merge_partials_tree(out, red)
    return stack_partials(out)


def _dispatch_point(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    max_batches_per_dispatch: int = 64,
    prng: str = "threefry",
    device=None,
) -> tuple[list, float]:
    """Run all trials of one point chunk by chunk WITHOUT fetching the
    statistics; returns (list of stacked device stats, actual QBER)."""
    device = resolve_device(device)
    n_err = num_errors_for(code.n_vars, qber)
    if n_err == 0:
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    actual_qber = n_err / code.n_vars

    # The device-side sum of iters^2 accumulates in exact int32; bound the
    # trials per chunk so chunk_trials * max_iterations^2 < 2^31 (host-side
    # merges across chunks are exact Python ints).
    mi2 = max(opts.max_iterations, 1) ** 2
    if batch * mi2 > 2**31 - 1:
        raise ValueError(
            f"batch ({batch}) x max_iterations^2 ({opts.max_iterations}^2) "
            "overflows the int32 iteration statistics; lower batch_size"
        )
    safe_batches = max(1, (2**31 - 1) // (batch * mi2))

    futures = []
    offset = 0
    while offset < trials:
        remaining = trials - offset
        n_batches = min(
            -(-remaining // batch), max_batches_per_dispatch, safe_batches
        )
        valid = min(n_batches * batch, remaining)
        futures.append(
            _point_chunk(code, point_key, n_err, offset, valid, batch,
                         n_batches, opts, prng, device)
        )
        offset += valid
    return futures, actual_qber


def _collect_point(futures: list) -> PointPartials:
    total = PointPartials()
    for stacked in futures:
        total = total.merge(partials_from_stacked(stacked.cpu()))
    return total


def run_point(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
    prng: str = "threefry",
    device=None,
) -> tuple[PointPartials, float]:
    """Run all trials of one (matrix, QBER) point; returns (partials, actual
    QBER).  ``device=None`` means the card and raises when there is none."""
    futures, actual_qber = _dispatch_point(
        code, point_key, qber, trials, batch, opts, max_batches_per_dispatch,
        prng, device,
    )
    total = _collect_point(futures)
    if tick is not None:
        tick(total.n_trials)
    return total, actual_qber
