"""Trials and channel inputs of the benchmarked semantics.

Monte-Carlo trial ``t`` of a point with key ``P`` (threefry words, see
``threefry.py``): ``T = fold_in(P, t)``; Alice's bit ``i`` is 1 where word
``i`` of ``bits(fold_in(T, 0))`` has its top bit clear; Bob's key flips
exactly ``k`` positions, the ``k`` smallest of the scores
``bits(fold_in(T, 1))`` ranked by (score, tie score, position) with the tie
scores ``bits(fold_in(fold_in(T, 1), 1))``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import threefry


def llr_magnitude(q32: np.float32) -> float:
    """``log((1 - q) / q)``: the ratio in float32, its log in float64 rounded
    to float32 (a QBER given as a float32)."""
    q = np.float32(q32)
    ratio = (np.float32(1.0) - q) / q
    return float(np.float32(np.log(np.float64(ratio))))


def num_errors(n_bits: int, qber: float) -> int:
    """The exact error count of a point: ``floor(N * qber)``."""
    return int(n_bits * qber)


def trial_magnitude(n_err: int, n_bits: int) -> float:
    """The a-priori LLR magnitude of a Monte-Carlo point: its QBER is the
    float32 quotient of the error count and the frame length."""
    return llr_magnitude(np.float32(n_err) / np.float32(n_bits))


def exact_weight_flips(scores: torch.Tensor, k: int, tie_scores) -> torch.Tensor:
    """bool ``[B, N]``: per row the ``k`` positions of smallest (score, tie
    score, position); ``tie_scores(rows)`` gives the tie words of those rows,
    drawn only where the threshold is shared by more positions than needed."""
    thresh = torch.sort(scores, dim=1).values[:, k - 1:k]
    below = scores < thresh
    at = scores == thresh
    need = k - below.sum(dim=1)
    flips = below | at
    excess = (at.sum(dim=1) > need).nonzero().flatten()
    if excess.numel():
        ties = tie_scores(excess)
        for r, row in enumerate(excess.tolist()):
            pos = at[row].nonzero().flatten()
            # rank by (tie word, position): a stable sort on the tie word
            order = torch.sort(ties[r, pos], stable=True).indices
            flips[row, pos] = False
            flips[row, pos[order[:int(need[row])]]] = True
    return flips


def trials(point_key: torch.Tensor, ids: torch.Tensor, n_bits: int, k: int):
    """``(alice, bob)`` uint8 ``[B, N]`` of the trials ``ids`` (int64 ``[B]``)."""
    tk = threefry.fold_in(point_key.to(ids.device), ids)
    alice = (threefry.bits(threefry.fold_in(tk, 0), n_bits) < 2**31).to(torch.uint8)
    ek = threefry.fold_in(tk, 1)
    scores = threefry.bits(ek, n_bits)
    flips = exact_weight_flips(
        scores, k, lambda rows: threefry.bits(threefry.fold_in(ek[rows], 1), n_bits))
    return alice, alice ^ flips.to(torch.uint8)


def syndromes(g, bits: torch.Tensor) -> torch.Tensor:
    """``bits [B, N]`` -> int8 ``[B, M]`` parities of the checks."""
    gathered = bits.to(torch.int32)[:, g.chk_adj]  # [B, M, dc]
    gathered = torch.where(g.chk_mask, gathered, 0)
    return (gathered.sum(dim=-1) & 1).to(torch.int8)
