"""Per-sweep-point statistics aggregation.

Counterpart of ``qkd_ldpc_tpu/sim/stats.py``: *mergeable partial sums*, so
statistics reduce on the device to seven int32 scalars per batch and
combine across sequential batches by addition:

- ``n_sp``    : trials whose decision syndrome converged (SP success)
- ``n_ldpc``  : of those, trials whose key matched Alice's (LDPC success)
- ``sum_it`` / ``sum_it2`` : sum of iters and iters^2 over SP-successful
  trials — mean and *population* std-dev are reconstructed from these
- ``min_it`` / ``max_it``  : over SP-successful trials; min is reported as
  0 when it never moved off its max_iterations initializer (including the
  corner case where every successful trial took exactly max_iterations).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class PointPartials:
    """Mergeable sufficient statistics for one (matrix, QBER) point."""

    n_trials: int = 0
    n_sp: int = 0
    n_ldpc: int = 0
    sum_it: float = 0.0
    sum_it2: float = 0.0
    min_it: int = 0  # valid only when n_sp > 0
    max_it: int = 0

    def merge(self, other: "PointPartials") -> "PointPartials":
        if other.n_sp == 0:
            min_it, max_it = self.min_it, self.max_it
        elif self.n_sp == 0:
            min_it, max_it = other.min_it, other.max_it
        else:
            min_it = min(self.min_it, other.min_it)
            max_it = max(self.max_it, other.max_it)
        return PointPartials(
            n_trials=self.n_trials + other.n_trials,
            n_sp=self.n_sp + other.n_sp,
            n_ldpc=self.n_ldpc + other.n_ldpc,
            sum_it=self.sum_it + other.sum_it,
            sum_it2=self.sum_it2 + other.sum_it2,
            min_it=min_it,
            max_it=max_it,
        )


def reduce_trials(
    syndromes_match: torch.Tensor,  # [B] bool
    keys_match: torch.Tensor,  # [B] bool
    iterations: torch.Tensor,  # [B] int32
    max_iterations: int,
    valid: torch.Tensor | None = None,  # [B] bool — mask for padded trials
) -> dict[str, torch.Tensor]:
    """Device-side reduction of a trial batch to scalar int32 partial sums.

    ``valid`` masks out padding trials (the runner always launches
    full-size batches; the tail batch marks its excess trials invalid).
    The sum of iters^2 per device-merged chunk must stay under 2^31: the
    runner bounds trials-per-dispatch accordingly.
    """
    if valid is None:
        valid = torch.ones_like(syndromes_match)
    sp = syndromes_match & valid
    it = iterations.to(torch.int32)
    it_sp = torch.where(sp, it, 0)
    i32 = torch.int32
    return dict(
        n_trials=valid.sum(dtype=i32),
        n_sp=sp.sum(dtype=i32),
        n_ldpc=(sp & keys_match).sum(dtype=i32),
        sum_it=it_sp.sum(dtype=i32),
        sum_it2=(it_sp * it_sp).sum(dtype=i32),
        min_it=torch.where(sp, it, max_iterations).min(),
        max_it=it_sp.max(),
    )


# Canonical field order of the single-transfer stacked form.
STAT_KEYS = ("n_trials", "n_sp", "n_ldpc", "sum_it", "sum_it2", "min_it", "max_it")


def stack_partials(reduced: dict) -> torch.Tensor:
    """Device-side [7] int32 stack of a reduction, for one-fetch readback."""
    return torch.stack([reduced[k].to(torch.int32) for k in STAT_KEYS])


def partials_from_stacked(stacked) -> PointPartials:
    """Host conversion of a fetched ``stack_partials`` tensor."""
    d = dict(zip(STAT_KEYS, (int(x) for x in stacked)))
    return PointPartials(
        n_trials=d["n_trials"],
        n_sp=d["n_sp"],
        n_ldpc=d["n_ldpc"],
        sum_it=float(d["sum_it"]),
        sum_it2=float(d["sum_it2"]),
        min_it=d["min_it"],
        max_it=d["max_it"],
    )


def partials_from_device(reduced: dict, max_iterations: int) -> PointPartials:
    """A ``reduce_trials`` dict on the device -> ``PointPartials`` with ONE
    fetch: the seven scalars stacked, then copied to the host.  The values
    are the reduction's own (``min_it`` stays at ``max_iterations`` where no
    trial succeeded), as in the JAX package, whose signature this keeps."""
    return partials_from_stacked(stack_partials(reduced).cpu())


@dataclasses.dataclass
class SimResult:
    """One CSV row of a sweep."""

    sim_number: int
    matrix_filename: str
    is_regular: bool
    num_bit_nodes: int
    num_check_nodes: int
    initial_qber: float
    iterations_successful_sp_mean: float
    iterations_successful_sp_std_dev: float
    iterations_successful_sp_min: int
    iterations_successful_sp_max: int
    ratio_trials_successful_sp: float
    ratio_trials_successful_ldpc: float

    @property
    def code_rate(self) -> float:
        return 1.0 - self.num_check_nodes / self.num_bit_nodes

    @property
    def fer(self) -> float:
        # FER = 1 - ratio_trials_successful_ldpc.
        return 1.0 - self.ratio_trials_successful_ldpc


def finalize_point(
    partials: PointPartials,
    *,
    sim_number: int,
    matrix_filename: str,
    is_regular: bool,
    num_bit_nodes: int,
    num_check_nodes: int,
    initial_qber: float,
    max_iterations: int,
) -> SimResult:
    """Per-point aggregation from partial sums."""
    n = partials.n_trials
    n_sp = partials.n_sp
    if n_sp > 0:
        mean = partials.sum_it / n_sp
        var = max(partials.sum_it2 / n_sp - mean * mean, 0.0)
        std = math.sqrt(var)
        min_it = 0 if partials.min_it == max_iterations else partials.min_it
        max_it = partials.max_it
    else:
        mean = std = 0.0
        min_it = max_it = 0
    return SimResult(
        sim_number=sim_number,
        matrix_filename=matrix_filename,
        is_regular=is_regular,
        num_bit_nodes=num_bit_nodes,
        num_check_nodes=num_check_nodes,
        initial_qber=initial_qber,
        iterations_successful_sp_mean=mean,
        iterations_successful_sp_std_dev=std,
        iterations_successful_sp_min=min_it,
        iterations_successful_sp_max=max_it,
        ratio_trials_successful_sp=n_sp / n,
        ratio_trials_successful_ldpc=partials.n_ldpc / n,
    )
