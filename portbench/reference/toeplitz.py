"""Seeded binary Toeplitz hashing: verification tags and privacy
amplification.

``T[i, j] = s[i - j + n - 1]`` for an ``n``-bit input and ``k`` output bits,
with ``s`` the ``n + k - 1`` top-bit-clear tests of the threefry words of
the hash's key; the hash of a frame ``x`` is ``T x`` over GF(2): a product
of float32 0/1 operands (its sums, at most ``n``, are exact; TF32 off),
taken mod 2.  The matrix is built by index arithmetic.
"""

from __future__ import annotations

import torch

from portbench.reference import threefry


def seed_bits(keys: torch.Tensor, length: int) -> torch.Tensor:
    """float32 ``[..., length]``: the seed bits of each key ``[..., 2]``."""
    return (threefry.bits(keys, length) < 2**31).to(torch.float32)


def matrix(key: torch.Tensor, n: int, k: int, device) -> torch.Tensor:
    """float32 ``[k, n]``."""
    return _matrices(seed_bits(key.to(device)[None], n + k - 1), n, k)[0]


def _matrices(s: torch.Tensor, n: int, k: int) -> torch.Tensor:
    i = torch.arange(k, device=s.device)[:, None]
    j = torch.arange(n, device=s.device)[None, :]
    return s[:, i - j + n - 1]  # [B, k, n]


def hash_bits(bits: torch.Tensor, key: torch.Tensor, k: int) -> torch.Tensor:
    """``bits [F, n]`` (0/1) -> uint8 ``[F, k]``."""
    return hash_many(bits[None], key[None], k)[0]


def hash_many(bits: torch.Tensor, keys: torch.Tensor, k: int) -> torch.Tensor:
    """``bits [B, F, n]`` (0/1), one key a batch entry (``keys [B, 2]``) ->
    uint8 ``[B, F, k]``: :func:`hash_bits` of each entry, in one product."""
    return hash_seeded(bits, seed_bits(keys.to(bits.device), bits.shape[2] + k - 1), k)


def hash_seeded(bits: torch.Tensor, s: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`hash_many` from the entries' seed bits ``s [B, n + k - 1]``."""
    T = _matrices(s, bits.shape[2], k)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = torch.bmm(bits.to(torch.float32), T.transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    return (acc.to(torch.int64) % 2).to(torch.uint8)
