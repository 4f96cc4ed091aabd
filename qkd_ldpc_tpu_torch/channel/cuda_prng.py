"""Per-trial random bit blocks: CUDA kernel wrapper and plain version.

Replaces ``qkd_ldpc_tpu/channel/pallas_prng.py::trial_words_pallas``.
The TPU kernel reseeds the TPU's hardware generator per trial, and its
stream exists on no other machine; the JAX package itself gives the
portable threefry stream for ``prng="pallas"`` off the TPU.  The port
therefore generates the **threefry** blocks — word ``i`` of a row is
``x0 ^ x1`` of ``threefry2x32(key, (0, i))`` — which equals
``jax.random.bits`` bit for bit and keeps the chunk/shard invariance
(every row depends on its own key only).

The kernel (``csrc/threefry_words.cu``) takes ``R`` keys per trial and
writes ``[B, R, N]`` words: the main path asks for the Alice row and the
error-score row in one launch (R=2), the tie path for one row (R=1).
"""

from __future__ import annotations

import ctypes

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel.threefry import random_bits, to_raw_int32

KERNEL_NAME = "trial_words"


def trial_words_plain(keys: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Plain PyTorch version: ``[B, R, 2]`` int64 keys -> ``[B, R, n_bits]``
    int32 raw words."""
    return random_bits(keys, n_bits)


def trial_words_cuda(keys: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation)."""
    if keys.device.type != "cuda":
        raise ValueError("trial_words_cuda needs a CUDA tensor")
    if keys.dtype != torch.int64 or keys.ndim != 3 or keys.shape[-1] != 2:
        raise ValueError("keys must be int64 [B, R, 2]")
    if not 0 < n_bits <= 65535 * 256:
        raise ValueError(f"n_bits {n_bits} outside the kernel's range")
    B, R, _ = keys.shape
    if B * R == 0:
        raise ValueError("empty key batch")
    raw = to_raw_int32(keys).contiguous()
    out = torch.empty((B, R, n_bits), dtype=torch.int32, device=keys.device)
    fn = _build.function(
        "threefry_words", "threefry_words",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p],
    )
    with torch.cuda.device(keys.device):
        err = fn(raw.data_ptr(), out.data_ptr(), B * R, n_bits,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(KERNEL_NAME, err)
    return out


def trial_words(keys: torch.Tensor, n_bits: int, backend: str = "auto") -> torch.Tensor:
    """Bit blocks for ``keys``; ``backend`` as in ``DecodeOptions.backend``."""
    if _build.use_kernel(backend, keys.device):
        return trial_words_cuda(keys, n_bits)
    return trial_words_plain(keys, n_bits)
