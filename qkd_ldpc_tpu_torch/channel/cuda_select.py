"""Per-row k-th smallest of uint32 scores: CUDA kernel wrapper and plain version.

Replaces ``qkd_ldpc_tpu/channel/pallas_select.py::kth_smallest_pallas``.
The exact-weight channel needs, for every trial, the k-th smallest of N
i.i.d. uint32 scores; everything strictly below it flips.  Both versions
run the same 32-pass bitwise prefix search (greedy largest prefix P with
``count(s < P) < k``, one bit per pass) and give the same threshold bit
for bit.

Unlike the TPU kernel, this one takes a per-row ``k`` (a scalar is
broadcast), so the second-word tie path of the channel goes through the
same kernel.  Scores and thresholds are int32 tensors holding raw uint32
bits (see ``channel/threefry.py``).
"""

from __future__ import annotations

import ctypes

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel.threefry import flip_sign

KERNEL_NAME = "kth_smallest"


def _rows_k(scores: torch.Tensor, k) -> torch.Tensor:
    """``k`` broadcast to one int32 per row of ``scores[..., N]``."""
    k = torch.as_tensor(k, dtype=torch.int32, device=scores.device)
    return k.broadcast_to(scores.shape[:-1])


def kth_smallest_plain(scores: torch.Tensor, k) -> torch.Tensor:
    """Plain PyTorch version: ``[..., N]`` int32 raw scores -> ``[..., 1]``
    raw threshold.  Each pass is one compare + row sum over ``[..., N]``."""
    k = _rows_k(scores, k)
    s = flip_sign(scores)
    prefix = torch.zeros(scores.shape[:-1], dtype=torch.int32, device=scores.device)
    for j in range(32):
        bit = 1 << (31 - j)
        test = prefix | (bit - 2**32 if bit >= 2**31 else bit)
        cnt = (s < flip_sign(test)[..., None]).sum(dim=-1, dtype=torch.int32)
        prefix = torch.where(cnt >= k, prefix, test)
    return prefix[..., None]


def kth_smallest_cuda(scores: torch.Tensor, k) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation)."""
    if scores.device.type != "cuda":
        raise ValueError("kth_smallest_cuda needs a CUDA tensor")
    if scores.dtype != torch.int32 or scores.ndim < 1:
        raise ValueError("scores must be int32 [..., N] (raw uint32 bits)")
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    n = scores.shape[-1]
    rows = scores.numel() // n if n else 0
    if rows == 0:
        raise ValueError("empty score block")
    # A Python int goes to the kernel as an argument: no tensor, no copy.
    k_rows = None if isinstance(k, int) else _rows_k(scores, k).contiguous()
    out = torch.empty(scores.shape[:-1] + (1,), dtype=torch.int32,
                      device=scores.device)
    fn = _build.function(
        "kth_smallest", "kth_smallest",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    with torch.cuda.device(scores.device):
        err = fn(scores.data_ptr(),
                 None if k_rows is None else k_rows.data_ptr(),
                 k if k_rows is None else 0, out.data_ptr(), rows, n,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(KERNEL_NAME, err)
    return out


def kth_smallest(scores: torch.Tensor, k, backend: str = "auto") -> torch.Tensor:
    """k-th smallest per row; ``backend`` as in ``DecodeOptions.backend``."""
    if _build.use_kernel(backend, scores.device):
        return kth_smallest_cuda(scores, k)
    return kth_smallest_plain(scores, k)
