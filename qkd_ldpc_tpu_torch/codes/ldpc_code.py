"""LDPC code representation: dense padded index tensors plus masks.

Counterpart of ``qkd_ldpc_tpu/codes/ldpc_code.py``.  The bipartite graph
of the parity-check matrix H is held as host numpy arrays — one layout
for regular and irregular codes:

- ``chk_adj[M, dc_max]``  : j-th variable adjacent to check c (0-padded)
- ``var_adj[N, dv_max]``  : k-th check adjacent to variable v (0-padded)
- ``chk_mask`` / ``var_mask`` : validity masks for the padded slots
- ``var_slot[N, dv_max]`` : flat check-major slot (c*dc_max + j) of each
  variable-side edge; padded slots point at the sentinel M*dc_max
- ``chk_slot[M, dc_max]`` : flat variable-major slot (v*dv_max + k) of each
  check-side edge; sentinel N*dv_max

There are no learned weights in this system: the code graph is the state
both packages share.  :func:`code_from_numpy` carries a graph built by
the JAX package across; :meth:`LDPCCode.to_device` places the index
tensors the decoder gathers with (including the dc-first maps) on a
torch device, once per device.
"""

from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property
from typing import Sequence

import numpy as np
import torch

_ARRAY_FIELDS = (
    "chk_adj", "chk_mask", "var_adj", "var_mask",
    "var_slot", "chk_slot", "var_deg", "chk_deg",
)
_STATIC_FIELDS = (
    "n_vars", "n_checks", "dv_max", "dc_max", "n_edges", "is_regular",
    "name", "qc",
)


@dataclasses.dataclass(frozen=True)
class DeviceCode:
    """The code's static index tensors on one torch device.

    Holds the canonical check-major adjacency (syndrome computation) and
    the dc-first maps of the decode loop: messages live as
    ``[dc_max, M, B]`` so slot j of every check is one contiguous
    ``[M, B]`` plane and the frame axis B is fastest.
    """

    chk_adj: torch.Tensor  # [M, dc] int64
    chk_mask: torch.Tensor  # [M, dc] bool
    chk_adj_T: torch.Tensor  # [dc * M] int64, dc-first flat gather index
    chk_mask_T: torch.Tensor  # [dc, M] bool
    chk_mask_T_i32: torch.Tensor  # [dc, M] int32 (the kernels' mask input)
    var_slot_T: torch.Tensor  # [dv * N] int64 into the flat [dc*M (+1)] messages
    var_has_pad: bool  # some variable has fewer than dv_max edges


def dc_first_maps(code: "LDPCCode") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """dc-first static index arrays from the code's canonical fields.

    ``var_slot`` stores flat check-major slots c*dc + j (sentinel M*dc);
    the dc-first flat layout is j*M + c.  Returns (chk_adj_T [dc, M],
    chk_mask_T [dc, M] bool, var_slot_T [dv, N] -> flat [dc*M] index with
    sentinel dc*M).
    """
    M, dc = code.n_checks, code.dc_max
    vs = code.var_slot.astype(np.int64)
    var_slot_T = np.where(
        code.var_mask, (vs % dc) * M + np.minimum(vs // dc, M - 1), M * dc
    ).T
    return code.chk_adj.T, code.chk_mask.T, var_slot_T.astype(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class LDPCCode:
    """A parity-check code as dense padded numpy arrays."""

    n_vars: int
    n_checks: int
    dv_max: int
    dc_max: int
    n_edges: int
    is_regular: bool
    name: str = ""
    # Quasi-cyclic layout (codes.qc): (z, chk_plan, var_plan) nested int
    # tuples, or None for unstructured codes.
    qc: tuple | None = None

    chk_adj: np.ndarray = None  # [M, dc_max] int32, var index per check slot
    chk_mask: np.ndarray = None  # [M, dc_max] bool
    var_adj: np.ndarray = None  # [N, dv_max] int32, check index per var slot
    var_mask: np.ndarray = None  # [N, dv_max] bool
    var_slot: np.ndarray = None  # [N, dv_max] int32 -> flat check-major slot
    chk_slot: np.ndarray = None  # [M, dc_max] int32 -> flat var-major slot
    var_deg: np.ndarray = None  # [N] int32
    chk_deg: np.ndarray = None  # [M] int32

    # Per-device index tensors, filled by to_device (the graph is static,
    # so each device gets one copy for the life of the code object).
    _device_cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False
    )

    @cached_property
    def fingerprint(self) -> str:
        """Content hash of the parity-check graph (shape + every edge);
        equal to the JAX package's fingerprint of the same graph."""
        h = hashlib.sha256()
        h.update(f"{self.n_vars},{self.n_checks},{self.dc_max}".encode())
        h.update(np.ascontiguousarray(self.chk_deg).tobytes())
        h.update(np.ascontiguousarray(
            np.where(self.chk_mask, self.chk_adj, -1)
        ).tobytes())
        return h.hexdigest()[:16]

    @property
    def code_rate(self) -> float:
        """R = 1 - M/N."""
        return 1.0 - self.n_checks / self.n_vars

    @property
    def n_info_bits(self) -> int:
        """K = N - M information bits per frame."""
        return self.n_vars - self.n_checks

    def to_device(self, device) -> DeviceCode:
        """The decoder's index tensors on ``device`` (built once, reused)."""
        device = torch.device(device)
        cached = self._device_cache.get(device)
        if cached is not None:
            return cached
        chk_adj_T, chk_mask_T, var_slot_T = dc_first_maps(self)

        def put(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(device)

        mask_T = put(chk_mask_T, torch.bool)
        dev = DeviceCode(
            chk_adj=put(self.chk_adj, torch.int64),
            chk_mask=put(self.chk_mask, torch.bool),
            chk_adj_T=put(chk_adj_T.reshape(-1), torch.int64),
            chk_mask_T=mask_T,
            chk_mask_T_i32=mask_T.to(torch.int32),
            var_slot_T=put(var_slot_T.reshape(-1), torch.int64),
            var_has_pad=not bool(self.var_mask.all()),
        )
        self._device_cache[device] = dev
        return dev

    @cached_property
    def dense(self) -> np.ndarray:
        """Materialize H as a dense uint8 [M, N] matrix (tests/small codes)."""
        H = np.zeros((self.n_checks, self.n_vars), dtype=np.uint8)
        rows = np.repeat(np.arange(self.n_checks), self.dc_max).reshape(
            self.n_checks, self.dc_max
        )
        H[rows[self.chk_mask], self.chk_adj[self.chk_mask]] = 1
        return H

    def __repr__(self) -> str:
        return (
            f"LDPCCode(name={self.name!r}, N={self.n_vars}, M={self.n_checks}, "
            f"R={self.code_rate:.3f}, E={self.n_edges}, dv_max={self.dv_max}, "
            f"dc_max={self.dc_max}, regular={self.is_regular})"
        )


def code_from_numpy(fields: dict) -> LDPCCode:
    """Build the port's code from another package's ``LDPCCode`` fields.

    ``fields`` maps every array field name to a numpy array and carries
    the static metadata (``n_vars`` ... ``name``) and the ``qc`` tuple.
    This is how a graph built by the JAX package is carried across.
    """
    missing = [
        k for k in _ARRAY_FIELDS + _STATIC_FIELDS if k not in fields
    ]
    if missing:
        raise ValueError(f"code_from_numpy: missing fields {missing}")
    dtypes = dict(chk_mask=bool, var_mask=bool)
    arrays = {
        k: np.ascontiguousarray(np.asarray(fields[k]), dtype=dtypes.get(k, np.int32))
        for k in _ARRAY_FIELDS
    }
    code = LDPCCode(
        n_vars=int(fields["n_vars"]),
        n_checks=int(fields["n_checks"]),
        dv_max=int(fields["dv_max"]),
        dc_max=int(fields["dc_max"]),
        n_edges=int(fields["n_edges"]),
        is_regular=bool(fields["is_regular"]),
        name=str(fields["name"]),
        qc=fields["qc"],
        **arrays,
    )
    if arrays["chk_adj"].shape != (code.n_checks, code.dc_max) or (
        arrays["var_slot"].shape != (code.n_vars, code.dv_max)
    ):
        raise ValueError("code_from_numpy: array shapes disagree with metadata")
    return code


def from_check_adjacency(
    check_neighbors: Sequence[np.ndarray],
    n_vars: int,
    name: str = "",
) -> LDPCCode:
    """Build an :class:`LDPCCode` from per-check neighbor lists.

    ``check_neighbors[c]`` is the array of variable indices adjacent to
    check ``c`` (0-based, unique).  The variable-side adjacency is derived
    by bucketing edges in ascending check order.
    """
    n_checks = len(check_neighbors)
    chk_deg = np.array([len(nb) for nb in check_neighbors], dtype=np.int32)
    if n_checks == 0 or n_vars == 0:
        raise ValueError("Empty parity-check matrix")
    if np.any(chk_deg == 0):
        bad = int(np.argmax(chk_deg == 0))
        raise ValueError(f"Row '{bad + 1}' weight cannot be equal to or less than zero.")

    # Flat edge list, check-major order.
    e_chk = np.repeat(np.arange(n_checks, dtype=np.int64), chk_deg)
    e_var = np.concatenate([np.asarray(nb, dtype=np.int64) for nb in check_neighbors])
    n_edges = e_var.size
    if e_var.min() < 0 or e_var.max() >= n_vars:
        raise ValueError("Variable index out of range in adjacency list")

    # Per-check slot position j of each edge.
    offsets = np.concatenate([[0], np.cumsum(chk_deg)])
    e_j = np.arange(n_edges, dtype=np.int64) - offsets[e_chk]

    # Detect duplicate edges (v appearing twice in one check row).
    key = e_chk * n_vars + e_var
    if np.unique(key).size != n_edges:
        raise ValueError("Duplicate edge in parity-check matrix")

    var_deg = np.bincount(e_var, minlength=n_vars).astype(np.int32)
    if np.any(var_deg == 0):
        bad = int(np.argmax(var_deg == 0))
        raise ValueError(
            f"Column '{bad + 1}' weight cannot be equal to or less than zero."
        )

    dc_max = int(chk_deg.max())
    dv_max = int(var_deg.max())

    chk_adj = np.zeros((n_checks, dc_max), dtype=np.int32)
    chk_mask = np.zeros((n_checks, dc_max), dtype=bool)
    chk_adj[e_chk, e_j] = e_var
    chk_mask[e_chk, e_j] = True

    # Variable-major ordering: sort edges by (var, check) — ascending
    # check index per variable, the order a column scan of H produces.
    order = np.lexsort((e_chk, e_var))
    f_var, f_chk = e_var[order], e_chk[order]
    f_offsets = np.concatenate([[0], np.cumsum(var_deg)])
    f_k = np.arange(n_edges, dtype=np.int64) - f_offsets[f_var]

    var_adj = np.zeros((n_vars, dv_max), dtype=np.int32)
    var_mask = np.zeros((n_vars, dv_max), dtype=bool)
    var_adj[f_var, f_k] = f_chk
    var_mask[f_var, f_k] = True

    # Permutation maps between the two flat layouts (sentinel-padded).
    var_slot = np.full((n_vars, dv_max), n_checks * dc_max, dtype=np.int32)
    var_slot[f_var, f_k] = (e_chk * dc_max + e_j)[order]
    chk_slot = np.full((n_checks, dc_max), n_vars * dv_max, dtype=np.int32)
    chk_slot[e_chk[order], e_j[order]] = f_var * dv_max + f_k

    is_regular = bool(np.all(var_deg == var_deg[0]) and np.all(chk_deg == chk_deg[0]))

    return LDPCCode(
        n_vars=int(n_vars),
        n_checks=int(n_checks),
        dv_max=dv_max,
        dc_max=dc_max,
        n_edges=int(n_edges),
        is_regular=is_regular,
        name=name,
        chk_adj=chk_adj,
        chk_mask=chk_mask,
        var_adj=var_adj,
        var_mask=var_mask,
        var_slot=var_slot,
        chk_slot=chk_slot,
        var_deg=var_deg,
        chk_deg=chk_deg.astype(np.int32),
    )


def from_dense(H: np.ndarray, name: str = "") -> LDPCCode:
    """Build an :class:`LDPCCode` from a dense 0/1 matrix [M, N]."""
    H = np.asarray(H)
    if H.ndim != 2:
        raise ValueError("Dense parity-check matrix must be 2-D")
    if not np.isin(H, (0, 1)).all():
        raise ValueError("Parity check matrix can only take values 0 or 1.")
    neighbors = [np.flatnonzero(row) for row in H]
    return from_check_adjacency(neighbors, n_vars=H.shape[1], name=name)
