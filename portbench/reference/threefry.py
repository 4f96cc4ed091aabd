"""Threefry-2x32 (20 rounds) with the conventions of ``jax.random`` under
``jax_threefry_partitionable``: a frozen copy of the stream the program's
trials are defined by, on int64 tensors that hold uint32 values.

- ``key(seed) = (seed >> 32, seed & 0xFFFFFFFF)`` (``PRNGKey`` for seeds
  below 2**32);
- ``fold_in(key, d) = threefry2x32(key, (0, d))``;
- ``bits(key, n)[i] = x0 ^ x1`` of ``threefry2x32(key, (0, i))``.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """One block on int64 tensors of uint32 values (operands broadcast)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """The int64 ``[2]`` key of a seed of up to 64 bits."""
    if not 0 <= seed < 2**64:
        raise ValueError("a seed is a whole number in [0, 2**64)")
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` of ``[..., 2]`` keys with ``data`` (int or int64 tensor)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    x0, x1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([x0, x1], dim=-1)


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., 2]`` keys -> ``[..., n]`` int64 words in [0, 2**32)."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k[..., 0:1], k[..., 1:2], torch.zeros_like(i), i)
    return x0 ^ x1


def word(seed: int, index: int) -> int:
    """A 32-bit word drawn from ``seed`` for ``index`` (derived seeds)."""
    return int(fold_in(key(seed), index)[1])
