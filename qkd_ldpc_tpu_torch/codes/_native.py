"""ctypes bindings for the native C++ data-loader / graph-builder.

Counterpart of ``qkd_ldpc_tpu/codes/_native.py``.  The reference's ingest
layer is C++ (``read_sparse_alist_matrix`` + adjacency builders,
``src/array_and_matrix_operations.cpp:4-292``); the framework's native
equivalent is ``native/qkd_ldpc_native.cpp`` at the repository root, a plain
C ABI that both packages load with ctypes.  The port builds its own copy of
the shared library with g++ on first use into ``_build/``
(:func:`qkd_ldpc_tpu_torch._build.build_native`, named by the hash of the
source), never the JAX package's build.  When the toolchain or the library
is unavailable (or ``QKD_LDPC_NO_NATIVE`` is set) every caller falls back to
the pure-NumPy builder, which produces bit-identical arrays; callers that
insist on the library (``native=True``) raise instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_lib_failed = False
failure = ""  # why the library is unavailable, once that is known


def load_library():
    """The loaded CDLL, building it if needed; None when unavailable."""
    global _lib, _lib_failed, failure
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("QKD_LDPC_NO_NATIVE"):
            _lib_failed, failure = True, "QKD_LDPC_NO_NATIVE is set"
            return None
        from qkd_ldpc_tpu_torch import _build

        try:
            lib = ctypes.CDLL(str(_build.build_native()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _lib_failed, failure = True, str(e)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ql_alist_open.restype = ctypes.c_void_p
        lib.ql_alist_open.argtypes = [
            ctypes.c_char_p, i32p, ctypes.POINTER(ctypes.c_int64)
        ]
        lib.ql_graph_open.restype = ctypes.c_void_p
        lib.ql_graph_open.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, ctypes.c_int64, i32p
        ]
        lib.ql_error.restype = ctypes.c_char_p
        lib.ql_error.argtypes = [ctypes.c_void_p]
        lib.ql_graph_fill.restype = ctypes.c_int32
        lib.ql_graph_fill.argtypes = [ctypes.c_void_p] + [i32p] * 8
        lib.ql_close.restype = None
        lib.ql_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _fill(lib, handle, n, m, dv, dc, is_regular, name):
    from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode

    try:
        err = lib.ql_error(handle)
        if err:
            raise ValueError(err.decode())
        chk_adj = np.zeros((m, dc), np.int32)
        chk_mask = np.zeros((m, dc), np.int32)
        var_adj = np.zeros((n, dv), np.int32)
        var_mask = np.zeros((n, dv), np.int32)
        var_slot = np.zeros((n, dv), np.int32)
        chk_slot = np.zeros((m, dc), np.int32)
        var_deg = np.zeros((n,), np.int32)
        chk_deg = np.zeros((m,), np.int32)
        rc = lib.ql_graph_fill(
            handle, _i32p(chk_adj), _i32p(chk_mask), _i32p(var_adj),
            _i32p(var_mask), _i32p(var_slot), _i32p(chk_slot),
            _i32p(var_deg), _i32p(chk_deg),
        )
        if rc != 0:
            err = lib.ql_error(handle)
            raise ValueError(err.decode() if err else "native graph build failed")
    finally:
        lib.ql_close(handle)

    return LDPCCode(
        n_vars=n,
        n_checks=m,
        dv_max=dv,
        dc_max=dc,
        n_edges=int(chk_deg.sum()),
        is_regular=bool(is_regular),
        name=name,
        chk_adj=chk_adj,
        chk_mask=chk_mask.astype(bool),
        var_adj=var_adj,
        var_mask=var_mask.astype(bool),
        var_slot=var_slot,
        chk_slot=chk_slot,
        var_deg=var_deg,
        chk_deg=chk_deg,
    )


def read_alist_native(path: str | os.PathLike, name: str = ""):
    """Parse an alist file with the C++ loader; None if unavailable."""
    lib = load_library()
    if lib is None:
        return None
    hdr = np.zeros(5, np.int32)
    n_edges = ctypes.c_int64(0)
    handle = lib.ql_alist_open(
        str(path).encode(), _i32p(hdr), ctypes.byref(n_edges)
    )
    n, m, dv, dc, reg = (int(x) for x in hdr)
    return _fill(lib, handle, n, m, dv, dc, reg, name)


def build_graph_native(check_deg: np.ndarray, e_var: np.ndarray,
                       n_vars: int, name: str = ""):
    """Build an LDPCCode from a check-major edge list with the C++
    graph-builder; None if unavailable."""
    lib = load_library()
    if lib is None:
        return None
    check_deg = np.ascontiguousarray(check_deg, np.int32)
    e_var = np.ascontiguousarray(e_var, np.int32)
    hdr = np.zeros(5, np.int32)
    handle = lib.ql_graph_open(
        np.int32(n_vars), np.int32(len(check_deg)), _i32p(check_deg),
        _i32p(e_var), np.int64(len(e_var)), _i32p(hdr),
    )
    n, m, dv, dc, reg = (int(x) for x in hdr)
    return _fill(lib, handle, n, m, dv, dc, reg, name)
