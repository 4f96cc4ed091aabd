"""The exact-weight channel's common path: CUDA kernel wrapper and plain version.

Replaces ``qkd_ldpc_tpu/channel/pallas_select.py::kth_smallest_pallas`` and
the passes around it in ``qkd_ldpc_tpu/channel/keys.py::_exact_weight_mask``.
For every trial the channel needs the k-th smallest ``t`` of N i.i.d. uint32
scores; everything strictly below it flips, and the count is completed from
the ties ``s == t`` in index order.  :func:`select_flip` does all of it and
returns Bob's row ``alice ^ flip`` with the threshold and one flag: whether
some row has more ties at its threshold than it needs (``n_at > need``), the
only case where the channel's second-word tie path
(``keys._uniform_ties``) changes the outcome.  :func:`complete_ties_cuda`
takes that path on the card, gated on the flag there (``keys.py``'s
``lax.cond``); ``keys._uniform_ties`` is its plain version.

The plain version finds ``t`` by the JAX package's 32-pass bitwise prefix
search (greedy largest prefix P with ``count(s < P) < k``); the kernel by a
radix select.  The k-th smallest value is unique, so both give the same
threshold bit for bit.  ``k`` may be one int, one int32 ``[1]`` tensor
(read by the kernel on the card: a captured trial chunk's error count) or
one per row (the tie path ranks its second words with a per-row k); without
Alice's row only the threshold is computed (:func:`kth_smallest`).  Scores
and thresholds are int32 tensors holding raw uint32 bits (see
``channel/threefry.py``).
"""

from __future__ import annotations

import ctypes

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel.threefry import flip_sign

KERNEL_NAME = "kth_smallest"
KERNEL_TIES = "complete_ties"


def _rows_k(scores: torch.Tensor, k) -> torch.Tensor:
    """``k`` broadcast to one int32 per row of ``scores[..., N]``."""
    k = torch.as_tensor(k, dtype=torch.int32, device=scores.device)
    if k.numel() == 1:
        k = k.reshape(())
    return k.broadcast_to(scores.shape[:-1])


def kth_smallest_plain(scores: torch.Tensor, k) -> torch.Tensor:
    """Plain PyTorch version of the threshold: ``[..., N]`` int32 raw scores
    -> ``[..., 1]`` raw threshold.  Each pass is one compare + row sum over
    ``[..., N]``; k <= 0 gives 0."""
    k = _rows_k(scores, k)
    s = flip_sign(scores)
    prefix = torch.zeros(scores.shape[:-1], dtype=torch.int32, device=scores.device)
    for j in range(32):
        bit = 1 << (31 - j)
        test = prefix | (bit - 2**32 if bit >= 2**31 else bit)
        cnt = (s < flip_sign(test)[..., None]).sum(dim=-1, dtype=torch.int32)
        prefix = torch.where(cnt >= k, prefix, test)
    return prefix[..., None]


def select_flip_plain(scores: torch.Tensor, k, alice: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`select_flip`: the 32-pass search, then
    the compare / row-sum / cumsum passes of the JAX package's
    ``_exact_weight_mask`` and ``alice ^ flip``."""
    _check(scores, alice)
    thresh = kth_smallest_plain(scores, k)
    if alice is None:
        return thresh, None, None
    k = _rows_k(scores, k)[..., None]
    s, t = flip_sign(scores), flip_sign(thresh)
    below, at = s < t, s == t
    need = k - below.sum(dim=-1, keepdim=True, dtype=torch.int32)
    n_at = at.sum(dim=-1, keepdim=True, dtype=torch.int32)
    tie_rank = at.cumsum(dim=-1, dtype=torch.int32) - 1
    flip = (below | (at & (tie_rank < need))) & (k > 0)
    excess = ((n_at > need) & (k > 0)).any().reshape(1).to(torch.int32)
    return thresh, alice ^ flip.to(torch.uint8), excess


def _check(scores: torch.Tensor, alice: torch.Tensor | None) -> None:
    if scores.dtype != torch.int32 or scores.ndim < 1:
        raise ValueError("scores must be int32 [..., N] (raw uint32 bits)")
    if scores.numel() == 0:
        raise ValueError("empty score block")
    if alice is not None and (alice.dtype != torch.uint8 or alice.shape != scores.shape
                              or alice.device != scores.device):
        raise ValueError("alice must be uint8 of the scores' shape, on their device")


def select_flip_cuda(scores: torch.Tensor, k, alice: torch.Tensor | None = None,
                     out: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None):
    """Launch the kernel on the current stream (no synchronisation).  Returns
    ``(threshold [..., 1], bob or None, excess [1] int32 or None)``.  ``out``
    = ``(threshold, bob, excess)`` (with Alice's row; ``excess`` must hold 0,
    the kernel only raises it) receives the results instead of new tensors:
    the form a captured program's conditional body launches, which may
    allocate nothing."""
    _check(scores, alice)
    if scores.device.type != "cuda":
        raise ValueError("select_flip_cuda needs a CUDA tensor")
    if not scores.is_contiguous() or (alice is not None and not alice.is_contiguous()):
        raise ValueError("scores and alice must be contiguous")
    n = scores.shape[-1]
    rows = scores.numel() // n
    # A Python int goes to the kernel as an argument: no tensor, no copy; a
    # tensor of one k is read by every row (stride 0).
    k_rows, k_stride = None, 1
    if isinstance(k, torch.Tensor) and k.numel() == 1 and k.dtype == torch.int32 and (
            k.device == scores.device):
        k_rows, k_stride = k.reshape(1), 0
    elif not isinstance(k, int):
        k_rows = _rows_k(scores, k).contiguous()
    if out is not None:
        thresh, bob, excess = out
        if alice is None or thresh.shape != scores.shape[:-1] + (1,) or (
                thresh.dtype != torch.int32) or bob.shape != alice.shape or (
                bob.dtype != torch.uint8) or excess.shape != (1,) or (
                excess.dtype != torch.int32) or any(
                t.device != scores.device or not t.is_contiguous()
                for t in (thresh, bob, excess)):
            raise ValueError("out must be (thresh int32 [..., 1], bob uint8 like alice, "
                             "excess int32 [1]), contiguous, on the scores' device")
    else:
        thresh = torch.empty(scores.shape[:-1] + (1,), dtype=torch.int32,
                             device=scores.device)
        bob = excess = None
        if alice is not None:
            bob = torch.empty_like(alice)
            excess = torch.zeros(1, dtype=torch.int32, device=scores.device)
    fn = _build.function(
        "kth_smallest", "select_flip",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p],
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(scores.device):
        err = fn(scores.data_ptr(), ptr(k_rows), k_stride, k if k_rows is None else 0,
                 ptr(alice), ptr(bob), thresh.data_ptr(), ptr(excess), rows, n,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(KERNEL_NAME, err)
    return thresh, bob, excess


def select_flip(scores: torch.Tensor, k, alice: torch.Tensor | None = None,
                backend: str = "auto"):
    """Threshold, Bob's row and the excess-ties flag per row of ``scores``
    (see the module docstring); ``backend`` as in ``DecodeOptions.backend``."""
    if _build.use_kernel(backend, scores.device):
        return select_flip_cuda(scores, k, alice)
    return select_flip_plain(scores, k, alice)


def kth_smallest(scores: torch.Tensor, k, backend: str = "auto") -> torch.Tensor:
    """k-th smallest per row, ``[..., 1]``; ``backend`` as in
    ``DecodeOptions.backend``."""
    return select_flip(scores, k, None, backend)[0]


def _k_on(k: torch.Tensor, device) -> torch.Tensor:
    """A one-element k as the int32 the kernels read on ``device``."""
    if k.dtype != torch.int32 or k.device != device:
        raise ValueError("a tensor k must be int32 on the scores' device")
    return k.reshape(1)


def complete_ties_cuda(scores: torch.Tensor, thresh: torch.Tensor, k,
                       second: torch.Tensor, alice: torch.Tensor, bob: torch.Tensor,
                       excess: torch.Tensor) -> torch.Tensor:
    """Launch the tie-completion kernel on the current stream: where the
    ``excess`` flag that :func:`select_flip` wrote is set (read on the card,
    never by the host), rewrite ``bob`` IN PLACE for the rows whose threshold
    ties are ranked by the ``second`` words, then by index
    (``keys._uniform_ties`` is its plain version); a no-op otherwise.  ``k``
    is an int or an int32 ``[1]`` tensor on the card.  Returns ``bob``."""
    _check(scores, alice)
    tensors = (scores, thresh, second, alice, bob, excess)
    if any(not t.is_cuda or not t.is_contiguous() or t.device != scores.device
           for t in tensors):
        raise ValueError("complete_ties_cuda needs contiguous CUDA tensors on one device")
    if second.shape != scores.shape or second.dtype != torch.int32:
        raise ValueError("second must be int32 of the scores' shape")
    if bob.shape != alice.shape or bob.dtype != torch.uint8:
        raise ValueError("bob must be uint8 of Alice's shape")
    if thresh.shape != scores.shape[:-1] + (1,) or thresh.dtype != torch.int32:
        raise ValueError("thresh must be int32 [..., 1]")
    if excess.shape != (1,) or excess.dtype != torch.int32:
        raise ValueError("excess must be int32 [1]")
    n = scores.shape[-1]
    k_dev = _k_on(k, scores.device) if isinstance(k, torch.Tensor) else None
    fn = _build.function(
        "kth_smallest", "complete_ties",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    with torch.cuda.device(scores.device):
        err = fn(scores.data_ptr(), thresh.data_ptr(),
                 None if k_dev is None else k_dev.data_ptr(),
                 0 if k_dev is not None else int(k), second.data_ptr(),
                 alice.data_ptr(), bob.data_ptr(), excess.data_ptr(), scores.numel() // n,
                 n, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(KERNEL_TIES, err)
    return bob
