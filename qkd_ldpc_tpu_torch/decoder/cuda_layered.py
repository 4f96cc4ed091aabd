"""The layered sweep as one CUDA kernel: wrapper of ``csrc/layered_sweep.cu``.

Replaces ``qkd_ldpc_tpu/decoder/pallas_layered.py`` (``_sweep_kernel``,
launched by ``sweep`` in ``_decode``): one launch runs all ``mb`` layers of
a sweep for every active frame and checks the decision syndrome.  A
frame's totals live in shared memory for the sweep when they fit a thread
block's share (``totals_in_shared_memory``), else they are updated where
they lie in global memory: same arithmetic, same results, chosen from the
shape alone.  What bounds the kernel on the card is the latency of its ten
serial layers, not its bytes; the header of the source says what the
design does about it (row tables in shared memory, the next layer's
messages and syndrome bits loaded ahead of the serial chain) and what was
measured slower and not kept (several lifted checks per thread with vector
accesses, a ring of bulk copies).  Every base-row degree from 2 up is taken:
degrees 2..8 run instances that unroll the cells of a row, larger ones an
instance that walks them in loops (its sum-product keeps the prefix
products in a float32 scratch ``[dc_max, B, z]`` that the wrapper
allocates); both equal the plain sweep bit for bit.  Its plain version is
``decoder.layered.layered_sweep_plain`` (same arguments, same results);
the decode loop around both is ``decoder.layered``, whose loop's
bookkeeping after a sweep the kernel runs in its last block (``step=``).

State layout (z fastest): ``t [nb, B, z]`` float32, ``Lr [ncells, B, z]``
in the message storage type, ``syn [mb, B, z]`` int8, ``act [B]`` bool.

The kernel updates ``t`` and ``Lr`` **in place** and leaves an inactive
frame (``act`` false) untouched; the plain version returns new tensors and
multiplies an inactive frame's update by zero — the same result for finite
state.  ``ok`` of an inactive frame is False here and is not used by the
decode loop (it takes ``act & ok``).
"""

from __future__ import annotations

import ctypes

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.decoder.cuda_kernels import _ALGORITHMS, _STORAGE_NAMES

KERNEL_NAME = "layered_sweep"
MIN_ROW_DEGREE = 2
MAX_SHARED_BYTES = 232448  # what one thread block may use on Hopper (227 KB)


def totals_in_shared_memory(nb: int, z: int, mb: int = 0, ncells: int = 0) -> bool:
    """Whether the kernel keeps a frame's totals in shared memory (the rule
    of ``totals_in_shared`` in layered_sweep.cu: the totals and the row tables
    of ``mb + 1 + 2 * ncells`` ints share a block's memory); larger frames
    stay in global memory."""
    tables = -(-(mb + 1 + 2 * ncells) * 4 // 16) * 16
    return nb * z * 4 + tables <= MAX_SHARED_BYTES


def copy_width(z: int, t: torch.Tensor) -> int:
    """Floats per access of the kernel's copy of ``t`` into and out of shared
    memory: 4 (16 bytes) when ``z`` is a multiple of 4 and ``t`` starts on a
    16-byte boundary, else 1.  Every other access of the kernel is one element
    wide and takes any ``z`` and any alignment."""
    return 4 if z % 4 == 0 and t.data_ptr() % 16 == 0 else 1


def refusal(max_row_degree: int) -> str | None:
    """Why the kernel cannot take a code of this base-row degree, or None if
    it can: every degree from 2 up runs (a base row of one cell is no
    check the schedule needs).  A refused degree raises under every backend
    that selects the kernel."""
    if max_row_degree < MIN_ROW_DEGREE:
        return (
            f"layered_sweep.cu takes a base-row degree of {MIN_ROW_DEGREE} or "
            f"more, not {max_row_degree}"
        )
    return None


def sweep_scratch_shape(tables, B: int, algorithm: str, dtype: torch.dtype):
    """The float32 scratch ``[dc_max, B, z]`` that the sweep kernel's loop
    instance (sum-product above the unrolled row degrees) needs, or None."""
    dc = tables.max_row_degree
    if algorithm != "sum-product" or dc <= _build.constant(
            "layered_sweep_" + _STORAGE_NAMES[dtype], "layered_sweep_max_unrolled_degree"):
        return None
    return (dc, B, tables.z)


def layered_sweep_cuda(t, Lr, syn, act, tables, *, threshold, clip, algorithm,
                       min_sum_alpha, min_sum_beta, scale, out=None, scratch=None,
                       step=None):
    """Launch one sweep on the current stream (no synchronisation); updates
    ``t`` and ``Lr`` in place and returns ``(t, Lr, ok [B] bool)``.  ``ok``
    is written into ``out`` and the loop instance's prefix products into
    ``scratch`` (:func:`sweep_scratch_shape`) when they are given, so a
    call inside a CUDA graph's loop allocates nothing.  ``step``
    (``device_loop.LoopTail``, LAYERED) launches the TAIL instance, whose
    last block runs the loop's bookkeeping over ``ok``.

    ``tables`` carries the code's static layer tables on the tensors' device:
    ``nb``, ``mb``, ``z``, ``max_row_degree`` and the int32 tensors ``row_ptr
    [mb + 1]``, ``col [ncells]``, ``shift [ncells]``.
    """
    if t.device.type != "cuda":
        raise ValueError("layered_sweep_cuda needs CUDA tensors")
    why = refusal(tables.max_row_degree)
    if why is not None:
        raise ValueError(why)
    if Lr.dtype not in _STORAGE_NAMES:
        raise ValueError(f"Lr must be float32/bfloat16/int8, got {Lr.dtype}")
    if (Lr.dtype == torch.int8) != (scale is not None):
        raise ValueError("scale is given exactly for int8 storage")
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"Unknown algorithm {algorithm!r}")
    nb, mb, z = tables.nb, tables.mb, tables.z
    ncells = tables.col.shape[0]
    B = t.shape[1] if t.ndim == 3 else -1
    if t.shape != (nb, B, z) or t.dtype != torch.float32 or B < 1:
        raise ValueError("t must be float32 [nb, B, z]")
    if Lr.shape != (ncells, B, z):
        raise ValueError("Lr must be [ncells, B, z]")
    if syn.shape != (mb, B, z) or syn.dtype != torch.int8:
        raise ValueError("syn must be int8 [mb, B, z]")
    if act.shape != (B,) or act.dtype != torch.bool:
        raise ValueError("act must be bool [B]")
    tensors = (t, Lr, syn, act, tables.row_ptr, tables.col, tables.shift)
    if any(x.device != t.device or not x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous and on one device")
    if out is None:
        ok = torch.empty((B,), dtype=torch.bool, device=t.device)
    elif (out.shape != (B,) or out.dtype != torch.bool or out.device != t.device
          or not out.is_contiguous()):
        raise ValueError("out must be contiguous bool [B] on the device of t")
    else:
        ok = out
    library = "layered_sweep_" + _STORAGE_NAMES[Lr.dtype]
    dc = tables.max_row_degree
    # the loop instance's sum-product keeps its prefix products in scratch
    need = sweep_scratch_shape(tables, B, algorithm, Lr.dtype)
    if need is None:
        scratch = None
    elif scratch is None:
        scratch = torch.empty(need, dtype=torch.float32, device=t.device)
    elif (scratch.dtype != torch.float32 or scratch.numel() < dc * B * z
          or scratch.device != t.device or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be contiguous float32 of {dc * B * z} elements")
    step_args = None if step is None else ctypes.byref(step.args(ok))
    fn = _build.function(
        library, "layered_sweep",
        [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2,
    )
    with torch.cuda.device(t.device):
        err = fn(
            _ALGORITHMS[algorithm], int(clip), dc, int(copy_width(z, t) == 4),
            t.data_ptr(), Lr.data_ptr(), syn.data_ptr(), act.data_ptr(),
            ok.data_ptr(), tables.row_ptr.data_ptr(), tables.col.data_ptr(),
            tables.shift.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            nb, mb, ncells, z, B,
            threshold, min_sum_alpha, min_sum_beta,
            scale if scale is not None else 1.0, step_args,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(KERNEL_NAME, err)
    return t, Lr, ok
