"""One flooding BP iteration as two kernels: CUDA wrappers and plain versions.

The check-node update replaces ``qkd_ldpc_tpu/decoder/pallas_kernels.py``:

- :func:`check_update_first` — ``check_update_pallas``: the iteration-1
  update on the never clipped a-priori LLRs;
- :func:`check_update_fused` — ``fused_update_pallas``: every later
  iteration, with the bit-node update ``Lq = clip(total[var] - Lr_prev)``
  recomputed inside the kernel;
- :func:`check_update_fused` with ``fresh`` — ``fused_update_fresh_pallas``:
  the same with a per-frame flag; a fresh frame's ``Lq`` skips the clip, so
  its ``(total = a-priori, Lr = 0)`` state replays iteration 1 exactly (the
  continuation runner restarts lanes in the middle of a batch).

All are one ``__global__`` template of ``csrc/check_update.cu`` and one
plain PyTorch function with a ``first`` switch and an optional ``fresh``
mask.  Unlike the TPU kernels, which are handed a gathered copy ``tot_chk
[dc, M, B]`` of the totals, these read ``total [N, B]`` through the check
adjacency themselves, so that copy is never made; and with a check's totals
at hand they also return the decision syndrome: ``ok [B]``, true where the
decisions ``total <= 0`` of the totals that went IN satisfy the target
syndrome (false on a fresh frame, which has run no iteration yet).

:func:`variable_update` (the second ``__global__`` function of the source)
takes the place of the tensor passes between two check updates: it sums a
variable's check messages in slot order, adds the a-priori LLR, rounds to
storage and writes ``total [N, B]``; on the frames whose ``active`` flag is
set it also writes the decision ``z`` and adds one to the frame's iteration
count, and it hands the check update its flag buffer ``ok``, all True.  So the loop of ``decoder/bp.py`` carries ``(total, Lr)`` and an
iteration is two launches with no tensor pass over the messages between.

What bounds both on the card is memory traffic, and what the design does
about it is in the header of ``csrc/check_update.cu``: each thread takes a
vector of adjacent frames (:func:`vector_width`: 16 bytes in the variable
update, 4 frames in the check update, whose time the width hardly moves); a
scalar instance of the same kernels takes a ragged ``B`` or an unaligned
tensor.  The check kernel takes every ``dc_max``: degrees 2..8 run instances
that unroll the slots, any other degree an instance that walks them in loops
(its sum-product keeps the prefix products in a float32 scratch ``[dc, M,
B]`` that the wrapper allocates); both equal the plain version bit for bit.

Tensors are in the message storage type (float32, bfloat16, or int8 fixed
point with ``scale`` LLR units per LSB), messages dc-first ``[dc, M, B]``
with the frame axis last.  Arithmetic is float32; the rounding points are
the JAX package's: bfloat16 round-to-nearest-even, int8 ``clip(round(x /
scale), +-127)`` with round half to even.  (The Pallas ``_store``
multiplies by ``1/scale`` where ``bp.to_storage`` divides; the two agree at
the default 0.25, and the port divides everywhere.)
"""

from __future__ import annotations

import ctypes

import torch

from qkd_ldpc_tpu_torch import _build

KERNEL_FIRST = "check_update_first"
KERNEL_FUSED = "check_update_fused"
KERNEL_FRESH = "check_update_fresh"
KERNEL_VARIABLE = "variable_update"
_ALGORITHMS = {"sum-product": 0, "min-sum": 1}
# DecodeOptions.message_dtype -> the torch type of the stored messages
STORAGE_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
}
_STORAGE_NAMES = {dtype: name for name, dtype in STORAGE_DTYPES.items()}


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
    # made on the device (no host copy: a decode graph captures this division)
    q = torch.round(x / torch.full((), scale, dtype=torch.float32, device=x.device))
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


def vector_width(kernel: str, B: int, dtype: torch.dtype, *tensors) -> int:
    """Frames per thread of the instance the wrapper of ``kernel``
    (``"check_update"`` or ``"variable_update"``) launches: the width
    compiled into the storage type's library when ``B`` is a multiple of it
    and every tensor is 16-byte aligned, else 1 (the scalar instance of the
    same kernel)."""
    vec = _build.constant(
        "check_update_" + _STORAGE_NAMES[dtype], kernel + "_vector_width")
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return vec if B % vec == 0 and aligned else 1


def _gathered(total, maps):
    """``total [N, B]`` -> ``[dc, M, B]`` through the check adjacency."""
    dc, M = maps.chk_mask_T.shape
    return total.index_select(0, maps.chk_adj_T).view(dc, M, total.shape[1])


def check_update_plain(total, lr_prev, syn, maps, *, first, threshold, clip,
                       algorithm, min_sum_alpha, min_sum_beta, scale, fresh=None,
                       ok=None, out=None, scratch=None):
    """Plain PyTorch version of the check kernel (``first`` and ``fresh``
    select which; ``fresh`` is a [B] bool mask of frames whose ``Lq`` is not
    clipped).  ``total`` is [N, B] in storage type, ``syn`` the [M, B] integer
    target syndrome, ``maps`` the code's ``DeviceCode``.  Returns ``(Lr, ok)``;
    ``ok`` is None when ``first``.  As the kernel's wrapper, it writes ``Lr``
    into ``out`` when given (which may be ``lr_prev`` itself) and the flags
    into ``ok`` when given; ``scratch`` is the kernel's and unused here."""
    a = _gathered(total, maps)
    dc = a.shape[0]
    masks = [maps.chk_mask_T[j][:, None] for j in range(dc)]
    lq = []
    for j in range(dc):
        v = _load(a[j], scale)
        if not first:
            v = v - _load(lr_prev[j], scale)
            if clip:
                clipped = torch.clamp(v, -threshold, threshold)
                v = clipped if fresh is None else torch.where(fresh[None, :], v, clipped)
        lq.append(v)
    syn_sign = torch.where(syn == 1, -1.0, 1.0)
    if algorithm == "min-sum":
        lr_out = _ms_messages(lq, masks, syn_sign, threshold, clip,
                              min_sum_alpha, min_sum_beta)
    else:
        lr_out = _sp_messages(lq, masks, syn_sign, threshold, clip)
    Lr = torch.stack([_store(o, a.dtype, scale) for o in lr_out])
    if first:
        return (Lr if out is None else out.copy_(Lr)), None
    # Decisions and their syndrome derive from the same storage-rounded totals.
    z_chk = (a <= 0) & maps.chk_mask_T[:, :, None]
    flags = ((z_chk.sum(dim=0, dtype=torch.int32) & 1) == syn).all(dim=0)
    if fresh is not None:
        flags = flags & ~fresh
    return (Lr if out is None else out.copy_(Lr)), (
        flags if ok is None else ok.copy_(flags))


def _need_cuda(ref):
    if ref.device.type != "cuda":
        raise ValueError("the CUDA kernels need CUDA tensors")


def _check_storage(total, scale, algorithm=None):
    if total.dtype not in _STORAGE_NAMES:
        raise ValueError(f"storage must be float32/bfloat16/int8, got {total.dtype}")
    if (total.dtype == torch.int8) != (scale is not None):
        raise ValueError("scale is given exactly for int8 storage")
    if algorithm is not None and algorithm not in _ALGORITHMS:
        raise ValueError(f"Unknown algorithm {algorithm!r}")


def _on_device_contiguous(ref, tensors):
    if any(t.device != ref.device or not t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous and on one device")


def check_update_cuda(total, lr_prev, syn, maps, *, first, threshold, clip,
                      algorithm, min_sum_alpha, min_sum_beta, scale, fresh=None,
                      ok=None, out=None, scratch=None):
    """Launch the check kernel on the current stream (no synchronisation);
    same arguments and results as :func:`check_update_plain`, with ``syn``
    int8.  ``ok`` ([B] bool, all True — as the variable update leaves it) is
    cleared IN PLACE where a check objects, and returned; without it the
    wrapper makes one.  ``out`` ([dc, M, B], may be ``lr_prev`` itself: a
    thread reads each message it overwrites before it writes it, and no other
    thread touches it) and ``scratch`` (:func:`check_scratch_shape`) are used
    instead of new tensors when given, so a call inside a CUDA graph's loop
    allocates nothing."""
    _check_storage(total, scale, algorithm)
    dc, M = maps.chk_adj_T_i32.shape
    N = maps.var_slot_T_i32.shape[1]
    # the kernel reads row adj[j][m] < N of total: a shorter total is read past its end
    if total.ndim != 2 or total.shape[0] != N or total.shape[1] < 1:
        raise ValueError(f"total must be [N, B] with the code's N = {N}")
    B = total.shape[1]
    if first and fresh is not None:
        raise ValueError("fresh belongs to the fused update, not to iteration 1")
    tensors = [total, maps.chk_adj_T_i32, maps.chk_mask_T_i32, syn]
    tensors += [] if first else [lr_prev]
    tensors += [] if fresh is None else [fresh]
    _on_device_contiguous(total, tensors)
    if not first and (lr_prev.shape != (dc, M, B) or lr_prev.dtype != total.dtype):
        raise ValueError("Lr_prev must be [dc, M, B] in the storage type of total")
    if syn.shape != (M, B) or syn.dtype != torch.int8:
        raise ValueError("syn must be int8 [M, B]")
    if fresh is not None and (fresh.shape != (B,) or fresh.dtype != torch.bool):
        raise ValueError("fresh must be bool [B]")
    if not first and ok is not None and (
            ok.shape != (B,) or ok.dtype != torch.bool or ok.device != total.device
            or not ok.is_contiguous()):
        raise ValueError("ok must be contiguous bool [B] on the device of total")
    _need_cuda(total)
    if first:
        ok = None
    elif ok is None:
        ok = torch.ones((B,), dtype=torch.bool, device=total.device)
    if out is None:
        out = torch.empty((dc, M, B), dtype=total.dtype, device=total.device)
    elif (out.shape != (dc, M, B) or out.dtype != total.dtype
          or out.device != total.device or not out.is_contiguous()):
        raise ValueError("out must be contiguous [dc, M, B] in the storage type of total")
    # the loop instance's sum-product keeps its prefix products in scratch
    need = check_scratch_shape(dc, M, B, algorithm, total.dtype)
    if need is None:
        scratch = None
    elif scratch is None:
        scratch = torch.empty(need, dtype=torch.float32, device=total.device)
    elif (scratch.dtype != torch.float32 or scratch.numel() < dc * M * B
          or scratch.device != total.device or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be contiguous float32 of {dc * M * B} elements")
    # the vector instance reads and writes vectors of every tensor, ok and
    # the scratch included
    vec = vector_width("check_update", B, total.dtype, *tensors, out,
                       *([] if first else [ok]), *([] if scratch is None else [scratch]))
    library = "check_update_" + _STORAGE_NAMES[total.dtype]
    fn = _build.function(
        library, "check_update",
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
        + [ctypes.c_float] * 4 + [ctypes.c_void_p],
    )
    with torch.cuda.device(total.device):
        err = fn(
            _ALGORITHMS[algorithm], int(first), int(clip), dc, vec,
            total.data_ptr(), maps.chk_adj_T_i32.data_ptr(),
            maps.chk_mask_T_i32.data_ptr(), 0 if first else lr_prev.data_ptr(),
            0 if fresh is None else fresh.data_ptr(), syn.data_ptr(),
            out.data_ptr(), 0 if first else ok.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), M, B,
            threshold, min_sum_alpha, min_sum_beta,
            scale if scale is not None else 1.0,
            torch.cuda.current_stream().cuda_stream,
        )
    name = KERNEL_FIRST if first else (KERNEL_FUSED if fresh is None else KERNEL_FRESH)
    _build.check_launch(name, err)
    return out, ok


def check_scratch_shape(dc: int, M: int, B: int, algorithm: str, dtype: torch.dtype):
    """The float32 scratch ``[dc, M, B]`` that the check kernel's loop
    instance (sum-product at a degree it does not unroll) needs, or None."""
    if algorithm != "sum-product" or 2 <= dc <= _build.constant(
            "check_update_" + _STORAGE_NAMES[dtype], "check_update_max_unrolled_degree"):
        return None
    return (dc, M, B)


def check_update_first(total0, syn, maps, *, backend="auto", out=None, scratch=None,
                       **kw):
    """Iteration-1 check update: the a-priori LLRs in storage type ``[N, B]``
    -> ``Lr [dc, M, B]`` (written into ``out`` when given)."""
    fn = check_update_cuda if _build.use_kernel(backend, total0.device) else check_update_plain
    return fn(total0, None, syn, maps, first=True, out=out, scratch=scratch, **kw)[0]


def check_update_fused(total, Lr_prev, syn, maps, *, backend="auto", fresh=None,
                       ok=None, out=None, scratch=None, **kw):
    """Fused bit-node + check update: ``(total, Lr_prev)`` -> ``(Lr, ok)``;
    with ``fresh`` ([B] bool) the frames it marks skip the clip of ``Lq``.
    ``ok`` is the all-True flag buffer that the variable update returned;
    ``out`` (may be ``Lr_prev``: an update in place) and ``scratch`` replace
    the new tensors of the kernel's wrapper."""
    fn = check_update_cuda if _build.use_kernel(backend, total.device) else check_update_plain
    return fn(total, Lr_prev, syn, maps, first=False, fresh=fresh, ok=ok, out=out,
              scratch=scratch, **kw)


def variable_update_plain(Lr, llr, z, count, active, maps, *, scale, out=None):
    """Plain PyTorch version of the variable kernel.  ``Lr [dc, M, B]`` in
    storage type, ``llr [N, B]`` float32, ``z [N, B]`` int8, ``count [B]``
    int32, ``active [B]`` bool.  Returns new ``(total [N, B], z, count, ok)``:
    the totals of every frame, decisions and counts moved on active frames,
    and ``ok [B]`` all True — the flags that the check update of these totals
    clears.  With ``out = (total, ok)`` it writes into those, and into ``z``
    and ``count``, in place, as the kernel does."""
    dc, M, B = Lr.shape
    dv = maps.var_slot_T.shape[0] // llr.shape[0]
    flat = Lr.view(dc * M, B)
    if maps.var_has_pad:
        # Padded variable slots index the sentinel row dc*M: a zero.
        flat = torch.cat([flat, flat.new_zeros((1, B))], dim=0)
    Lr_var = _load(flat.index_select(0, maps.var_slot_T).view(dv, -1, B), scale)
    acc = Lr_var[0]
    for k in range(1, dv):  # explicit adds in slot order
        acc = acc + Lr_var[k]
    total = _store(llr + acc, Lr.dtype, scale)
    z_new = (total <= 0).to(torch.int8)  # total <= 0 -> bit 1
    z_next = torch.where(active[None, :], z_new, z)
    count_next = count + active.to(torch.int32)
    if out is None:
        return total, z_next, count_next, torch.ones_like(active)
    total_out, ok = out
    return (total_out.copy_(total), z.copy_(z_next), count.copy_(count_next),
            ok.fill_(True))


def variable_update_cuda(Lr, llr, z, count, active, maps, *, scale, out=None):
    """Launch the variable kernel on the current stream (no synchronisation).
    Same arguments as :func:`variable_update_plain`; ``z`` and ``count`` are
    updated IN PLACE and returned beside the new ``total`` and ``ok`` (or
    the given ``out = (total, ok)``)."""
    _check_storage(Lr, scale)
    dv, N = maps.var_slot_T_i32.shape
    if Lr.ndim != 3 or Lr.shape[:2] != maps.chk_adj_T_i32.shape or Lr.shape[2] < 1:
        raise ValueError("Lr must be [dc, M, B]")
    dc, M, B = Lr.shape
    tensors = [Lr, maps.var_slot_T_i32, llr, z, count, active]
    _on_device_contiguous(Lr, tensors)
    if llr.shape != (N, B) or llr.dtype != torch.float32:
        raise ValueError("llr must be float32 [N, B]")
    if z.shape != (N, B) or z.dtype != torch.int8:
        raise ValueError("z must be int8 [N, B]")
    if count.shape != (B,) or count.dtype != torch.int32:
        raise ValueError("count must be int32 [B]")
    if active.shape != (B,) or active.dtype != torch.bool:
        raise ValueError("active must be bool [B]")
    _need_cuda(Lr)
    if out is None:
        total = torch.empty((N, B), dtype=Lr.dtype, device=Lr.device)
        ok = torch.empty((B,), dtype=torch.bool, device=Lr.device)
    else:
        total, ok = out
        if (total.shape != (N, B) or total.dtype != Lr.dtype or ok.shape != (B,)
                or ok.dtype != torch.bool):
            raise ValueError("out must be (total [N, B] in storage type, ok bool [B])")
        _on_device_contiguous(Lr, [total, ok])
    vec = vector_width("variable_update", B, Lr.dtype, *tensors, total, ok)
    fn = _build.function(
        "check_update_" + _STORAGE_NAMES[Lr.dtype], "variable_update",
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
    )
    with torch.cuda.device(Lr.device):
        err = fn(
            vec, Lr.data_ptr(), maps.var_slot_T_i32.data_ptr(), llr.data_ptr(),
            active.data_ptr(), total.data_ptr(), z.data_ptr(), count.data_ptr(),
            ok.data_ptr(), N, B, dv, dc * M, scale if scale is not None else 1.0,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(KERNEL_VARIABLE, err)
    return total, z, count, ok


def variable_update(Lr, llr, z, count, active, maps, *, backend="auto", scale,
                    out=None):
    """Variable-node update: ``Lr`` -> ``(total, z, count, ok)`` (see the
    plain version); the kernel updates ``z`` and ``count`` in place, and
    writes into ``out = (total, ok)`` when given."""
    fn = variable_update_cuda if _build.use_kernel(backend, Lr.device) else variable_update_plain
    return fn(Lr, llr, z, count, active, maps, scale=scale, out=out)
