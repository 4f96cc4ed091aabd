"""Check-node update of the BP edge sweep: CUDA kernel wrappers and plain versions.

Replaces ``qkd_ldpc_tpu/decoder/pallas_kernels.py``:

- :func:`check_update_first` — ``check_update_pallas``: the iteration-1
  update on the gathered, never clipped a-priori LLRs;
- :func:`check_update_fused` — ``fused_update_pallas``: every later
  iteration, with the bit-node update ``Lq = clip(tot_chk - Lr_prev)``
  recomputed inside the kernel.

Both are one CUDA source (``csrc/check_update.cu``) and one plain PyTorch
function with a ``first`` switch.  All tensors are in the message storage
type (float32, bfloat16, or int8 fixed point with ``scale`` LLR units per
LSB) and dc-first, ``[dc, M, B]`` with the frame axis last.  Arithmetic is
float32; the rounding points are the JAX package's: bfloat16
round-to-nearest-even, int8 ``clip(round(x / scale), +-127)`` with round
half to even.  (The Pallas ``_store`` multiplies by ``1/scale`` where
``bp.to_storage`` divides; the two agree at the default 0.25, and the
port divides everywhere.)
"""

from __future__ import annotations

import ctypes

import torch

from qkd_ldpc_tpu_torch import _build

KERNEL_FIRST = "check_update_first"
KERNEL_FUSED = "check_update_fused"
_ALGORITHMS = {"sum-product": 0, "min-sum": 1}
_DC_INSTANCES = range(2, 9)  # template instances compiled in check_update.cu
_STORAGE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8",
}


def _load(q: torch.Tensor, scale) -> torch.Tensor:
    """Storage -> float32 (int8 fixed point dequantizes by ``scale``)."""
    x = q.to(torch.float32)
    return x * scale if scale is not None else x


def _store(x: torch.Tensor, dtype: torch.dtype, scale) -> torch.Tensor:
    """float32 -> storage (saturating int8 fixed point when ``scale`` is set).
    The divisor is a tensor so the division is a true division on every
    device, never a multiplication by a reciprocal."""
    if scale is None:
        return x.to(dtype)
    q = torch.round(x / torch.tensor(scale, dtype=torch.float32, device=x.device))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def _sp_messages(lq, masks, syn, threshold, clip):
    """Sum-product outputs from float32 inputs: list of [M, B] planes."""
    dc = len(lq)
    one = torch.ones_like(lq[0])
    t = [torch.where(masks[j], torch.tanh(lq[j] * 0.5), one) for j in range(dc)]
    pre, suf = [None] * dc, [None] * dc
    acc = one
    for j in range(dc):
        pre[j] = acc
        acc = acc * t[j]
    acc = one
    for j in range(dc - 1, -1, -1):
        suf[j] = acc
        acc = acc * t[j]
    out = []
    for j in range(dc):
        x = pre[j] * suf[j] * syn
        lr = torch.log1p(2.0 * x / (1.0 - x))
        if clip:
            lr = torch.clamp(lr, -threshold, threshold)
        out.append(lr)
    return out


def _ms_messages(lq, masks, syn, threshold, clip, alpha, beta):
    """Normalized/offset min-sum outputs.  The excluded edge is the FIRST
    occurrence (lowest slot) of the row minimum: a strict-< running scan,
    not ``argmin``, whose tie rule is not promised on every device."""
    dc = len(lq)
    inf = torch.full_like(lq[0], float("inf"))
    absl = [torch.where(masks[j], lq[j].abs(), inf) for j in range(dc)]
    neg = [(masks[j] & (lq[j] < 0.0)).to(torch.int32) for j in range(dc)]
    m1 = absl[0]
    s1 = torch.zeros_like(neg[0])
    tot_neg = neg[0]
    for j in range(1, dc):
        upd = absl[j] < m1
        s1 = torch.where(upd, j, s1)
        m1 = torch.where(upd, absl[j], m1)
        tot_neg = tot_neg + neg[j]
    m2 = inf
    for j in range(dc):
        m2 = torch.minimum(m2, torch.where(s1 == j, inf, absl[j]))
    out = []
    for j in range(dc):
        loo = torch.where(s1 == j, m2, m1)
        if beta:
            loo = torch.clamp_min(loo - beta, 0.0)
        loo_neg = (tot_neg - neg[j]) & 1
        sign = torch.where(loo_neg == 1, -1.0, 1.0) * syn
        lr = alpha * sign * loo
        if clip:
            lr = torch.clamp(lr, -threshold, threshold)
        out.append(lr)
    return out


def check_update_plain(a, lr_prev, chk_mask_i32, syn_sign, *, first, threshold,
                       clip, algorithm, min_sum_alpha, min_sum_beta, scale):
    """Plain PyTorch version of both kernels (``first`` selects which)."""
    dc = a.shape[0]
    masks = [chk_mask_i32[j][:, None] != 0 for j in range(dc)]
    lq = []
    for j in range(dc):
        v = _load(a[j], scale)
        if not first:
            v = v - _load(lr_prev[j], scale)
            if clip:
                v = torch.clamp(v, -threshold, threshold)
        lq.append(v)
    if algorithm == "min-sum":
        out = _ms_messages(lq, masks, syn_sign, threshold, clip,
                           min_sum_alpha, min_sum_beta)
    else:
        out = _sp_messages(lq, masks, syn_sign, threshold, clip)
    return torch.stack([_store(o, a.dtype, scale) for o in out])


def check_update_cuda(a, lr_prev, chk_mask_i32, syn_sign, *, first, threshold,
                      clip, algorithm, min_sum_alpha, min_sum_beta, scale):
    """Launch the kernel on the current stream (no synchronisation)."""
    if a.device.type != "cuda":
        raise ValueError("check_update_cuda needs CUDA tensors")
    if a.dtype not in _STORAGE_NAMES or a.ndim != 3:
        raise ValueError(f"messages must be [dc, M, B] float32/bfloat16/int8, got {a.dtype}")
    if (a.dtype == torch.int8) != (scale is not None):
        raise ValueError("scale is given exactly for int8 storage")
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"Unknown algorithm {algorithm!r}")
    dc, M, B = a.shape
    if dc not in _DC_INSTANCES:
        raise ValueError(
            f"check_update.cu has no instance for dc_max={dc} "
            f"(compiled: {_DC_INSTANCES.start}..{_DC_INSTANCES.stop - 1})"
        )
    if M * B == 0:
        raise ValueError("empty message tensor")
    tensors = [a, chk_mask_i32, syn_sign] + ([] if first else [lr_prev])
    if any(t.device != a.device or not t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous and on one device")
    if not first and (lr_prev.shape != a.shape or lr_prev.dtype != a.dtype):
        raise ValueError("tot_chk and Lr_prev must agree in shape and dtype")
    if chk_mask_i32.shape != (dc, M) or chk_mask_i32.dtype != torch.int32:
        raise ValueError("mask must be int32 [dc, M]")
    if syn_sign.shape != (M, B) or syn_sign.dtype != torch.float32:
        raise ValueError("syn_sign must be float32 [M, B]")
    out = torch.empty_like(a)
    fn = _build.function(
        "check_update_" + _STORAGE_NAMES[a.dtype], "check_update",
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
        + [ctypes.c_float] * 4 + [ctypes.c_void_p],
    )
    with torch.cuda.device(a.device):
        err = fn(
            _ALGORITHMS[algorithm], int(first), int(clip), dc,
            a.data_ptr(), 0 if first else lr_prev.data_ptr(),
            chk_mask_i32.data_ptr(), syn_sign.data_ptr(), out.data_ptr(), M, B,
            threshold, min_sum_alpha, min_sum_beta,
            scale if scale is not None else 1.0,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(KERNEL_FIRST if first else KERNEL_FUSED, err)
    return out


def check_update_first(Lq, chk_mask_i32, syn_sign, *, backend="auto", **kw):
    """Iteration-1 check update: ``Lq [dc, M, B]`` -> ``Lr [dc, M, B]``."""
    fn = check_update_cuda if _build.use_kernel(backend, Lq.device) else check_update_plain
    return fn(Lq, None, chk_mask_i32, syn_sign, first=True, **kw)


def check_update_fused(tot_chk, Lr_prev, chk_mask_i32, syn_sign, *, backend="auto", **kw):
    """Fused bit-node + check update: ``(tot_chk, Lr_prev)`` -> ``Lr``."""
    fn = check_update_cuda if _build.use_kernel(backend, tot_chk.device) else check_update_plain
    return fn(tot_chk, Lr_prev, chk_mask_i32, syn_sign, first=False, **kw)
