"""threefry2x32 on torch tensors: the part of ``jax.random`` the channel uses.

The JAX package derives every trial's randomness with ``jax.random``
(``PRNGKey``, ``fold_in``, ``bits``, ``bernoulli`` — keys.py:55,61,218-255
there).  The port must reproduce those streams bit for bit, so this module
implements the same counter-based generator (Threefry-2x32, 20 rounds,
Salmon et al. 2011) with JAX's conventions (``jax_threefry_partitionable``
on, as JAX 0.9 ships it):

- ``PRNGKey(seed) = (0, seed)``
- ``fold_in(key, d) = threefry2x32(key, (0, d))``, both words the new key
- ``bits(key, (n,))[i] = x0 ^ x1`` of ``threefry2x32(key, (0, i))``
- ``bernoulli(key, 0.5, (n,))[i] = (bits[i] >> 31) == 0``

Word representation.  PyTorch has few operators for ``uint32`` on the CPU,
so 32-bit words travel in two forms, stated once here:

- **keys** are ``int64`` tensors ``[..., 2]`` holding values in
  ``[0, 2**32)``; the arithmetic below masks with ``0xFFFFFFFF``.
- **bit blocks** (random words, channel scores, thresholds) are ``int32``
  tensors holding the raw uint32 bit pattern — the storage the CUDA
  kernels read and write.  Unsigned order is signed order after
  :func:`flip_sign` (xor with ``0x80000000``).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SIGN = -(2**31)  # 0x80000000 as an int32 value


def flip_sign(words: torch.Tensor) -> torch.Tensor:
    """int32 raw-uint32 words -> int32 whose signed order is the unsigned order."""
    return words ^ _SIGN


def to_raw_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors with the same 32 bits."""
    return (((words + 2**31) & _M32) - 2**31).to(torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """One Threefry-2x32 block on int64 tensors holding uint32 values
    (operands broadcast); returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor (on the CPU)."""
    if not 0 <= seed <= _M32:
        raise ValueError("seed must fit in 32 bits")
    return torch.tensor([0, seed], dtype=torch.int64)


def key_from_words(words) -> torch.Tensor:
    """A JAX key as numpy (``np.asarray(jax.random.PRNGKey(s))``, uint32
    ``[..., 2]``) -> the port's int64 key ``[..., 2]`` (on the CPU), so both
    packages compute with the same keys."""
    w = np.asarray(words)
    if w.shape[-1:] != (2,) or w.dtype.kind not in "iu" or (w < 0).any() or (w > _M32).any():
        raise ValueError("a key is [..., 2] words of 32 bits")
    return torch.as_tensor(w.astype(np.int64))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``key`` is ``[..., 2]``, ``data`` an int or an
    int64 tensor of uint32 values broadcastable against ``key[..., 0]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    x0, x1 = threefry2x32(
        key[..., 0], key[..., 1], torch.zeros_like(data), data
    )
    return torch.stack([x0, x1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: ``[..., 2]`` keys ->
    ``[..., n]`` int32 raw words, on the key's device.  JAX counts a block of
    any shape by its flat row-major index, so ``bits(key, (B, N))`` is this
    block of ``B * N`` words reshaped (for ``B * N < 2**32``)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(
        key[..., 0:1], key[..., 1:2], torch.zeros_like(i), i
    )
    return to_raw_int32(x0 ^ x1)


def bernoulli_half(words: torch.Tensor) -> torch.Tensor:
    """``jax.random.bernoulli(key, 0.5)`` from the key's bit block: the
    uniform built from a word is below one half exactly when the word's
    top bit is clear, so the draw is ``1 - (word >> 31)`` -> uint8."""
    return (words >= 0).to(torch.uint8)
