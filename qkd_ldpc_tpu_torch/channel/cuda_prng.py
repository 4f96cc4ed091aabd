"""Per-trial random rows of the channel: CUDA kernel wrapper and plain version.

Replaces ``qkd_ldpc_tpu/channel/pallas_prng.py::trial_words_pallas``.
The TPU kernel reseeds the TPU's hardware generator per trial, and its
stream exists on no other machine; the JAX package itself gives the
portable threefry stream for ``prng="pallas"`` off the TPU.  The port
therefore generates the **threefry** rows, as ``jax.random`` gives them in
``qkd_ldpc_tpu/channel/keys.py::make_trials_from_ids``.  Trial ``t`` of a
point has the key ``fold_in(point_key, t)``; from it

- ``"alice"``: Alice's bits, ``bernoulli(fold_in(key, 0), 0.5)`` as uint8;
- ``"scores"``: the channel's error scores, ``bits(fold_in(key, 1))``;
- ``"ties"``: the second-word tie scores, ``bits(fold_in(fold_in(key, 1), 1))``

(bit blocks as int32 raw words, see ``channel/threefry.py``).  Every row
depends on its own trial id only, which keeps the chunk/shard invariance.

The kernel (``csrc/threefry_words.cu``) derives each trial's keys on the
card from the point key and the trial id, so the key tree costs no host
launch.  Trial ids come as a ``range`` (step 1, taken mod 2**32: no ids
tensor at all), as a :class:`DeviceRange` (a range after a base that lies
on the card) or as a ``[B]`` integer tensor.  A point key on the host goes
to the kernel as two arguments; a key on the card (int64 words, or int32
raw words) is read by the kernel from device memory, with no host read.
A captured trial chunk (``sim/runner.py``) launches with a key on the card
and a device range: its replays change both in device memory.

:func:`block_words` (the same source) writes the flat block of
``jax.random.bits(key, shape)``, the protocol's key blocks, optionally
gated on a flag on the card (the tie words of ``introduce_errors``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel.threefry import (
    bernoulli_half,
    fold_in,
    random_bits,
    to_raw_int32,
)
from qkd_ldpc_tpu_torch.utils import canonical_device, resolve_device

KERNEL_NAME = "trial_words"
KERNEL_BLOCK = "block_words"
ALICE, SCORES, TIES = "alice", "scores", "ties"
ROWS = (ALICE, SCORES, TIES)
_M32 = 0xFFFFFFFF


class DeviceRange(NamedTuple):
    """Trial ids ``base + r`` for ``r`` in ``offsets`` (mod 2**32): ``base``
    an int32 ``[1]`` tensor holding a raw uint32, which the kernel reads on
    the card; ``offsets`` a ``range`` of step 1."""

    base: torch.Tensor
    offsets: range


def _check(point_key: torch.Tensor, n_bits: int, ids, rows) -> int:
    """Validate the arguments; returns the batch size."""
    if tuple(point_key.shape) != (2,):
        raise ValueError("point_key must be a [2] key")
    if not rows or len(set(rows)) != len(rows) or not set(rows) <= set(ROWS):
        raise ValueError(f"rows must be distinct names out of {ROWS}, got {rows!r}")
    if n_bits <= 0:
        raise ValueError("n_bits must be positive")
    if isinstance(ids, DeviceRange):
        if ids.base.shape != (1,) or ids.base.dtype != torch.int32:
            raise ValueError("a device range's base must be an int32 [1] tensor")
        ids = ids.offsets
    if isinstance(ids, range):
        if ids.step != 1:
            raise ValueError("a trial range must have step 1")
        return len(ids)
    if not isinstance(ids, torch.Tensor) or ids.ndim != 1:
        raise ValueError("trial ids must be a range or a 1-d tensor")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise ValueError("trial ids must be integers")
    return ids.shape[0]


def _id_tensor(ids, device) -> torch.Tensor:
    if isinstance(ids, DeviceRange):
        return (_id_tensor(ids.offsets, device) + _words(ids.base, device)) & _M32
    if isinstance(ids, range):
        return (torch.arange(len(ids), dtype=torch.int64, device=device) + ids.start) & _M32
    return ids.to(device=device, dtype=torch.int64) & _M32


def _words(t: torch.Tensor, device) -> torch.Tensor:
    """int64 key words or int32 raw words -> int64 values in [0, 2**32)."""
    return t.to(device=device, dtype=torch.int64) & _M32


def _ids_device(ids):
    """The device a tensor of ids (or a device range's base) lies on, else None."""
    if isinstance(ids, DeviceRange):
        return ids.base.device
    return ids.device if isinstance(ids, torch.Tensor) else None


def _key_args(key: torch.Tensor, device):
    """(word 0, word 1, pointer, owner) for a kernel: a key on the host as
    two arguments, a key on the card as a pointer to its raw uint32 words
    (``owner``, the tensor it points into, is kept until the launch)."""
    if not key.is_cuda:
        k0, k1 = (int(w) & _M32 for w in key.tolist())
        return k0, k1, None, None
    if canonical_device(key.device) != canonical_device(device):
        raise ValueError("a key on the card must lie on the launch's device")
    words = (key if key.dtype == torch.int32 else to_raw_int32(key)).contiguous()
    return 0, 0, words.data_ptr(), words


def trial_words_plain(point_key: torch.Tensor, n_bits: int, ids,
                      rows=(ALICE, SCORES), device=None) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version: the int64 ``fold_in`` tree, then ``random_bits``
    (and ``bernoulli_half`` for Alice's row).  One ``[B, n_bits]`` tensor per
    name in ``rows``: uint8 for ``"alice"``, int32 raw words otherwise."""
    _check(point_key, n_bits, ids, rows)
    device = torch.device(device) if device is not None else (
        _ids_device(ids) or torch.device("cpu"))
    trial_keys = fold_in(_words(point_key, device), _id_tensor(ids, device))
    error_keys = fold_in(trial_keys, 1) if (SCORES in rows or TIES in rows) else None
    out = {}
    if ALICE in rows:
        out[ALICE] = bernoulli_half(random_bits(fold_in(trial_keys, 0), n_bits))
    if SCORES in rows:
        out[SCORES] = random_bits(error_keys, n_bits)
    if TIES in rows:
        out[TIES] = random_bits(fold_in(error_keys, 1), n_bits)
    return tuple(out[r] for r in rows)


def trial_words_cuda(point_key: torch.Tensor, n_bits: int, ids,
                     rows=(ALICE, SCORES), device=None,
                     gate: torch.Tensor | None = None,
                     out: tuple[torch.Tensor, ...] | None = None) -> tuple[torch.Tensor, ...]:
    """Launch the kernel on the current stream (no synchronisation).  A
    ``range`` of ids needs ``device``; a tensor of ids is moved to it.  A
    point key on the card is read there.  ``gate`` (int32 ``[1]`` on the
    card, e.g. ``select_flip``'s excess-ties flag): where it reads 0 the
    kernel writes nothing and the rows are left unset — the condition is
    tested on the card, not fetched.  ``out`` (one contiguous ``[B,
    n_bits]`` tensor per name in ``rows``, of that row's type, on the
    device) receives the rows instead of new tensors: the form a captured
    program's conditional body launches, which may allocate nothing."""
    batch = _check(point_key, n_bits, ids, rows)
    if device is None:
        device = _ids_device(ids)
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        raise ValueError("trial_words_cuda needs a CUDA device")
    if batch == 0:
        raise ValueError("empty trial batch")
    if not n_bits <= 65535 * 1024:
        raise ValueError(f"n_bits {n_bits} outside the kernel's range")
    k0, k1, key_ptr, key_words = _key_args(point_key, device)
    id_t = base = None
    if isinstance(ids, DeviceRange):
        base, ids = ids.base, ids.offsets
        if canonical_device(base.device) != canonical_device(device):
            raise ValueError("a device range's base must lie on the launch's device")
    elif isinstance(ids, torch.Tensor):
        id_t = ids.to(device=device, dtype=torch.int64).contiguous()
    dtypes = {r: torch.uint8 if r == ALICE else torch.int32 for r in rows}
    if out is None:
        out = {r: torch.empty((batch, n_bits), device=device, dtype=dtypes[r]) for r in rows}
    else:
        if len(out) != len(rows) or any(
                t.shape != (batch, n_bits) or t.dtype != dtypes[r] or not t.is_contiguous()
                or canonical_device(t.device) != canonical_device(device)
                for r, t in zip(rows, out)):
            raise ValueError("out must hold one contiguous [B, n_bits] tensor per row, of "
                             "the row's type, on the launch's device")
        out = dict(zip(rows, out))
    if gate is not None and (gate.shape != (1,) or gate.dtype != torch.int32
                             or not gate.is_cuda):
        raise ValueError("gate must be an int32 [1] tensor on the rows' device")
    fn = _build.function(
        "threefry_words", "trial_rows",
        [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    )

    def ptr(name):
        return out[name].data_ptr() if name in out else None

    with torch.cuda.device(device):
        err = fn(k0, k1, key_ptr, None if id_t is None else id_t.data_ptr(),
                 0 if id_t is not None else ids.start & _M32,
                 None if base is None else base.data_ptr(), batch, n_bits,
                 ptr(ALICE), ptr(SCORES), ptr(TIES),
                 None if gate is None else gate.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    del key_words
    _build.check_launch(KERNEL_NAME, err)
    return tuple(out[r] for r in rows)


def trial_words(point_key: torch.Tensor, n_bits: int, ids, rows=(ALICE, SCORES),
                backend: str = "auto", device=None) -> tuple[torch.Tensor, ...]:
    """The rows ``rows`` of the trials ``ids`` on ``device``; ``backend`` as
    in ``DecodeOptions.backend``.  ``device=None`` means the device of a
    tensor of ids (or of a device range's base), and for a ``range`` the card
    (raises without one)."""
    if device is None:
        device = _ids_device(ids)
    device = resolve_device(device)
    if _build.use_kernel(backend, device):
        return trial_words_cuda(point_key, n_bits, ids, rows, device)
    return trial_words_plain(point_key, n_bits, ids, rows, device)


def block_words_plain(key: torch.Tensor, count: int, device) -> torch.Tensor:
    """Plain version of :func:`block_words_cuda`: ``random_bits`` on
    ``device``."""
    return random_bits(_words(key, device), count)


def block_words_cuda(key: torch.Tensor, count: int, device,
                     gate: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the flat-block kernel on the current stream: ``count`` int32
    raw words of ``key`` (on the host, or on the card and read there) on
    ``device``.  ``gate`` (int32 ``[1]`` on the card): where it reads 0 the
    kernel writes nothing and the block is left unset."""
    if tuple(key.shape) != (2,):
        raise ValueError("key must be a [2] key")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("block_words_cuda needs a CUDA device")
    if not 0 < count <= 2**32:
        raise ValueError(f"a block of {count} words is outside the kernel's range")
    if gate is not None and (gate.shape != (1,) or gate.dtype != torch.int32
                             or canonical_device(gate.device) != canonical_device(device)):
        raise ValueError("gate must be an int32 [1] tensor on the block's device")
    k0, k1, key_ptr, key_words = _key_args(key, device)
    out = torch.empty((count,), dtype=torch.int32, device=device)
    fn = _build.function(
        "threefry_words", "block_words",
        [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p],
    )
    with torch.cuda.device(device):
        err = fn(k0, k1, key_ptr, out.data_ptr(), count,
                 None if gate is None else gate.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    del key_words
    _build.check_launch(KERNEL_BLOCK, err)
    return out


def block_words(key: torch.Tensor, count: int, device, backend: str = "auto",
                gate: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.random.bits(key, (count,), uint32)`` as int32 raw words on
    ``device``: the kernel on the card (``gate`` as in
    :func:`block_words_cuda`), the plain version elsewhere (no gate: there the
    caller reads its flag before it asks)."""
    device = torch.device(device)
    if _build.use_kernel(backend, device):
        return block_words_cuda(key, count, device, gate)
    if gate is not None:
        raise ValueError("a gated block is the kernel's; read the flag off the card")
    return block_words_plain(key, count, device)
