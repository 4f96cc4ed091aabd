"""Statistics of a Monte-Carlo point and of a sweep row, from per-trial
outcomes: trials, syndrome successes (``n_sp``), key successes among them
(``n_ldpc``), and the sum, sum of squares, least and most of the iteration
counts of the syndrome successes."""

from __future__ import annotations

import math

import torch

from portbench.reference import channel, codes
from portbench.reference.decode import Decoder, decode

KEYS = ("n_trials", "n_sp", "n_ldpc", "sum_it", "sum_it2", "min_it", "max_it")


def point(dec: Decoder, g: codes.DeviceGraph, point_key: torch.Tensor, n_err: int,
          n_trials: int, width: int = 4096) -> dict:
    """The statistics of trials ``0 .. n_trials-1`` of a point, decoded
    ``width`` trials at a time on the graph's device."""
    dev = g.chk_adj.device
    mag = channel.trial_magnitude(n_err, g.n_vars)
    out = dict(n_trials=0, n_sp=0, n_ldpc=0, sum_it=0, sum_it2=0, min_it=None, max_it=0)
    for lo in range(0, n_trials, width):
        ids = torch.arange(lo, min(lo + width, n_trials), dtype=torch.int64, device=dev)
        alice, bob = channel.trials(point_key, ids, g.n_vars, n_err)
        llr = torch.where(bob == 1, -mag, mag).to(torch.float32)
        z, iters, ok = decode(dec, g, llr, channel.syndromes(g, alice))
        match = (z == alice).all(dim=1)
        it = iters[ok].to(torch.int64)
        out["n_trials"] += ids.numel()
        out["n_sp"] += int(ok.sum())
        out["n_ldpc"] += int((ok & match).sum())
        out["sum_it"] += int(it.sum())
        out["sum_it2"] += int((it * it).sum())
        if it.numel():
            lo_it = int(it.min())
            out["min_it"] = lo_it if out["min_it"] is None else min(out["min_it"], lo_it)
            out["max_it"] = max(out["max_it"], int(it.max()))
    return out


def row(stats: dict, max_iterations: int) -> dict:
    """A sweep row's written statistics from a point's."""
    n, n_sp = stats["n_trials"], stats["n_sp"]
    if n_sp:
        mean = stats["sum_it"] / n_sp
        std = math.sqrt(max(stats["sum_it2"] / n_sp - mean * mean, 0.0))
        lo = 0 if stats["min_it"] == max_iterations else stats["min_it"]
        hi = stats["max_it"]
    else:
        mean = std = 0.0
        lo = hi = 0
    return dict(iterations_successful_sp_mean=mean, iterations_successful_sp_std_dev=std,
                iterations_successful_sp_min=lo, iterations_successful_sp_max=hi,
                ratio_trials_successful_sp=n_sp / n,
                ratio_trials_successful_ldpc=stats["n_ldpc"] / n)


def relative_gap(got: float, want: float) -> float:
    """``|got - want|`` relative to ``|want|``, and absolute below 1."""
    return abs(got - want) / max(abs(want), 1.0)
