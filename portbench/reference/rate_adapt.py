"""Rate-compatible puncturing and shortening over one mother code, and the
LLRs Bob decodes an adapted frame from.

Worked out again from the protocol (Elkouss, Martinez-Mateo and Martin): a
fixed set of ``d`` frame positions is modulated, the first ``d`` of numpy's
permutation of the frame seeded by the family's seed; at step ``i`` the
first ``p = i * grid`` of them (in permutation order) are punctured and the
other ``d - p`` shortened, each set used in ascending order.  The rest, in
ascending order, carry the payload.

- Alice's punctured bits are her private randomness: the top-bit-clear test
  of the threefry words of her frame key, ``frames * p`` words in row-major
  order.  The shortened bits are the same test on the words of the shared
  seed's key ``(seed >> 32, seed & 0xFFFFFFFF)``.
- Bob's LLRs: the channel's ``+-mag`` at payload positions, 0 at punctured
  positions (erasures), ``+64`` for a shortened 0 and ``-64`` for a 1.
- The step of a QBER estimate ``q`` at efficiency ``f``: the punctured count
  ``M - f h(q) (N - d)`` (``h`` the binary entropy), rounded down to the
  grid and clamped to ``[0, d]``, over the grid.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import threefry

KNOWN_LLR = 64.0


def entropy(q: float) -> float:
    return -q * math.log2(q) - (1.0 - q) * math.log2(1.0 - q)


def step(n_vars: int, n_checks: int, d: int, grid: int, qber: float, f: float) -> int:
    p = n_checks - f * entropy(qber) * (n_vars - d)
    p = math.floor(p / grid) * grid
    return min(max(p, 0), d) // grid


@dataclasses.dataclass(frozen=True)
class Plan:
    """One step's positions (ascending int64 arrays)."""

    n_vars: int
    n_checks: int
    key_idx: np.ndarray
    punct_idx: np.ndarray
    short_idx: np.ndarray

    @property
    def leak(self) -> int:
        """``M - p``: what reconciling a frame discloses."""
        return self.n_checks - self.punct_idx.size


def plan(n_vars: int, n_checks: int, d: int, p: int, seed: int) -> Plan:
    perm = np.random.default_rng(seed).permutation(n_vars)
    mask = np.ones(n_vars, bool)
    mask[perm[:d]] = False
    return Plan(n_vars, n_checks, np.flatnonzero(mask), np.sort(perm[:p]), np.sort(perm[p:d]))


def half_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 ``[n]``: 1 where threefry word ``i`` of ``key`` has its top bit clear."""
    return (threefry.bits(key, n) < 2**31).to(torch.uint8)


def pins(pl: Plan, shared_seed: int, device) -> torch.Tensor:
    """The shortened positions' shared bits (uint8 ``[s]``)."""
    return half_bits(threefry.key(shared_seed, device), pl.short_idx.size)


def punctured_words(frame_keys: torch.Tensor, frames: int, d: int) -> torch.Tensor:
    """uint8 ``[..., frames * d]``: the first ``frames * p`` of them are the
    punctured bits of ``frames`` frames at any ``p <= d`` (the words are
    counted by index), so one call serves every step of a frame key."""
    return half_bits(frame_keys, frames * d)


def frames(pl: Plan, payload: torch.Tensor, frame_key: torch.Tensor, shared_seed: int,
           words: torch.Tensor | None = None) -> torch.Tensor:
    """Alice's full frames ``[F, N]`` uint8 from her payloads ``[F, l]``;
    ``words`` (:func:`punctured_words` of ``frame_key``) where made already."""
    F, dev = payload.shape[0], payload.device
    out = torch.zeros((F, pl.n_vars), dtype=torch.uint8, device=dev)
    out[:, torch.as_tensor(pl.key_idx, device=dev)] = payload
    p = pl.punct_idx.size
    if p:
        if words is None:
            words = half_bits(frame_key.to(dev), F * p)
        out[:, torch.as_tensor(pl.punct_idx, device=dev)] = words[:F * p].view(F, p)
    if pl.short_idx.size:
        out[:, torch.as_tensor(pl.short_idx, device=dev)] = pins(pl, shared_seed, dev)
    return out


def llr(pl: Plan, bob_payload: torch.Tensor, mag: float, shared_seed: int) -> torch.Tensor:
    """Bob's float32 LLRs ``[F, N]`` of his payloads ``[F, l]``."""
    F, dev = bob_payload.shape[0], bob_payload.device
    out = torch.zeros((F, pl.n_vars), dtype=torch.float32, device=dev)
    out[:, torch.as_tensor(pl.key_idx, device=dev)] = torch.where(
        bob_payload == 1, -mag, mag).to(torch.float32)
    if pl.short_idx.size:
        out[:, torch.as_tensor(pl.short_idx, device=dev)] = torch.where(
            pins(pl, shared_seed, dev) == 1, -KNOWN_LLR, KNOWN_LLR)
    return out
