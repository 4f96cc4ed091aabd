"""alist parity-check-matrix format reader/writer.

Counterpart of ``qkd_ldpc_tpu/codes/alist.py``: the same strict token rule
and messages, and files (with their QC sidecars) byte-identical to the JAX
package's.  Format: http://www.inference.org.uk/mackay/codes/alist.html (also
https://rptu.de/channel-codes/matrix-file-formats).  Parsing semantics and
validation mirror the reference's ``read_sparse_alist_matrix``
(``src/array_and_matrix_operations.cpp:109-292``): header/body consistency
checks, per-line non-zero counts vs the declared weights, and 1-based to
0-based index conversion.  Zero-padded entries inside adjacency lines
(used by alist for irregular codes) are dropped.
"""

from __future__ import annotations

from pathlib import Path

import re

import numpy as np

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode, from_check_adjacency


_INT_TOKEN = re.compile(r"[+-]?[0-9]+")


def _parse_int_lines(text: str, path: str) -> list[list[int]]:
    lines = text.splitlines()
    if not lines:
        raise ValueError(f"File is empty or cannot be read properly: {path}")
    out = []
    for line in lines:
        # ASCII-decimal tokens only, one integer per whitespace-separated
        # token: the same strictness as the native C++ tokenizer (which
        # requires whitespace after every number).  Deliberately stricter
        # than the reference's `istringstream >> int`, which parses glued
        # sign characters ("52+74" -> 52, 74) and silently IGNORES the
        # rest of a line after any unparsable junk — a corrupted file can
        # misparse into a wrong graph there; both of our parsers reject
        # it instead (differential-fuzzed, tests/test_fuzz.py).
        toks = line.split()
        if not all(_INT_TOKEN.fullmatch(t) for t in toks):
            raise ValueError(f"An error occurred while parsing file: {path}")
        out.append([int(t) for t in toks])
    return out


def parse_alist(text: str, path: str = "<string>", name: str = "") -> LDPCCode:
    """Parse alist-format text into an :class:`LDPCCode`."""
    vec = _parse_int_lines(text, path)
    if len(vec) < 4:
        raise ValueError(f"Insufficient data in the file: {path}")
    if len(vec[0]) != 2 or len(vec[1]) != 2:
        raise ValueError(f"File format does not match the alist format: {path}")

    n_cols, n_rows = vec[0]
    max_col_w, max_row_w = vec[1]
    col_weights = vec[2]
    row_weights = vec[3]

    if len(vec) < 4 + len(col_weights) + len(row_weights):
        raise ValueError(f"Insufficient data in the file: {path}")
    if n_cols != len(col_weights):
        raise ValueError(
            f"Number of columns '{n_cols}' is not the same as the length of "
            f"the third line '{len(col_weights)}'. File: {path}"
        )
    if n_rows != len(row_weights):
        raise ValueError(
            f"Number of rows '{n_rows}' is not the same as the length of "
            f"the fourth line '{len(row_weights)}'. File: {path}"
        )
    if max(col_weights) > max_col_w or max(row_weights) > max_row_w:
        raise ValueError(f"Declared max weights are inconsistent. File: {path}")

    col_lines = vec[4 : 4 + n_cols]
    row_lines = vec[4 + n_cols : 4 + n_cols + n_rows]

    # Non-zero counts per adjacency line must match the declared weights
    # (reference validation at array_and_matrix_operations.cpp:209-243).
    for i, line in enumerate(col_lines):
        nz = sum(1 for x in line if x != 0)
        if nz != col_weights[i]:
            raise ValueError(
                f"Number of non-zero elements '{nz}' in the line '{4 + i + 1}' "
                f"does not match the weight in the third line "
                f"'{col_weights[i]}'. File: {path}"
            )
    for i, line in enumerate(row_lines):
        nz = sum(1 for x in line if x != 0)
        if nz != row_weights[i]:
            raise ValueError(
                f"Number of non-zero elements '{nz}' in the line "
                f"'{4 + n_cols + i + 1}' does not match the weight in the "
                f"fourth line '{row_weights[i]}'. File: {path}"
            )

    # Build from the row (check-node) adjacency; 1-based -> 0-based.
    check_neighbors = [
        np.array([x - 1 for x in line if x != 0], dtype=np.int64)
        for line in row_lines
    ]
    code = from_check_adjacency(check_neighbors, n_vars=n_cols, name=name)

    # Cross-validate the column adjacency against the derived one.
    for v, line in enumerate(col_lines):
        declared = sorted(x - 1 for x in line if x != 0)
        derived = sorted(code.var_adj[v, code.var_mask[v]].tolist())
        if declared != derived:
            raise ValueError(
                f"Column adjacency for variable {v + 1} disagrees with row "
                f"adjacency. File: {path}"
            )
    return code


def read_alist(path: str | Path, native: bool | None = None) -> LDPCCode:
    """Read an alist file into an :class:`LDPCCode`.

    Uses the native C++ loader (``native/qkd_ldpc_native.cpp``, built
    lazily by ``codes._native``) when available — one O(E) pass over the file, the framework's
    counterpart of the reference's C++ ingest — and falls back to the pure
    Python/NumPy parser otherwise.  Both produce identical tensors
    (tests/test_native.py); ``native=False`` forces the Python path.

    A ``<file>.qc.json`` sidecar (written by :func:`write_alist` for
    quasi-cyclic codes) reattaches the QC layout after load —
    verified against the parsed graph, so a stale or mismatched sidecar
    raises instead of silently mis-routing messages.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Failed to open file: {path}")
    code = None
    if native or native is None:
        from qkd_ldpc_tpu_torch.codes._native import read_alist_native

        code = read_alist_native(path, name=path.name)
        if code is None and native:
            from qkd_ldpc_tpu_torch.codes import _native

            raise RuntimeError(f"Native alist loader unavailable: {_native.failure}")
    if code is None:
        code = parse_alist(path.read_text(), str(path), name=path.name)
    return _attach_qc_sidecar(code, path)


def qc_sidecar_path(path: str | Path) -> Path:
    return Path(str(path) + ".qc.json")


def _attach_qc_sidecar(code: LDPCCode, path: Path) -> LDPCCode:
    """Reattach (and verify) the QC layout from a sidecar, if present.

    The layered schedule (and ``routing="roll"``) needs ``code.qc``;
    without this, a generated QC code would reload as an unstructured
    graph that the layered schedule refuses.  The sidecar
    stores only the base matrix cells (z + {(row, col): shift}); the full
    static layout is rebuilt by the same function construction uses, and
    the lifted adjacency it implies is checked cell-by-cell against the
    parsed graph.  ``code.fingerprint`` hashes the graph alone, so
    attaching qc never changes it.
    """
    import dataclasses
    import json

    sidecar = qc_sidecar_path(path)
    if not sidecar.exists():
        return code
    try:
        meta = json.loads(sidecar.read_text())
        z = int(meta["z"])
        cells = {(int(i), int(j)): int(s) for i, j, s in meta["cells"]}
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"Corrupt QC sidecar {sidecar}: {e}") from e
    from qkd_ldpc_tpu_torch.codes.qc import _row_cols, qc_layout_from_cells

    if z < 1 or code.n_vars % z or code.n_checks % z:
        raise ValueError(
            f"QC sidecar {sidecar}: z={z} does not divide the code "
            f"dimensions N={code.n_vars}, M={code.n_checks}"
        )
    nb, mb = code.n_vars // z, code.n_checks // z
    chk_adj = np.asarray(code.chk_adj)
    chk_mask = np.asarray(code.chk_mask)
    # One vectorized compare per BASE row (the lifted adjacency repeats
    # blockwise for all z rows of a base row, so per-lifted-check Python
    # loops would cost O(M) interpreter work on every load of a
    # production-sized code).  EXACT slot order, not just edge-set
    # equality: the QC layout assumes the canonical ascending-base-
    # column slot order, and leave-one-out products round in slot order
    # — a permuted file would make the layout disagree with the graph.
    r = np.arange(z)[:, None]
    row_cols = _row_cols(cells, mb)
    for i in range(mb):
        js = np.asarray(row_cols[i], dtype=np.int64)
        shifts = np.asarray([cells[(i, j)] for j in row_cols[i]], np.int64)
        d = js.size
        rows = slice(i * z, (i + 1) * z)
        mask = chk_mask[rows]
        expect = js[None, :] * z + (r + shifts[None, :]) % z
        if (
            d > mask.shape[1]
            or not mask[:, :d].all()
            or mask[:, d:].any()
            or not np.array_equal(chk_adj[rows, :d], expect)
        ):
            raise ValueError(
                f"QC sidecar {sidecar} does not describe the graph in "
                f"{path} (first mismatch at base row {i}); delete the "
                "stale sidecar or regenerate the pair"
            )
    return dataclasses.replace(
        code, qc=qc_layout_from_cells(cells, z, nb, mb, code.dc_max, code.dv_max)
    )


def write_alist(code: LDPCCode, path: str | Path) -> None:
    """Write a code in alist format (1-based, no zero padding).

    Quasi-cyclic codes (``code.qc`` set) additionally write a
    ``<file>.qc.json`` sidecar carrying the lift description (z + base
    cells), so :func:`read_alist` round-trips the QC layout — without it
    the reloaded code could not take the layered schedule.
    """
    lines = [
        f"{code.n_vars} {code.n_checks}",
        f"{code.dv_max} {code.dc_max}",
        " ".join(str(int(d)) for d in code.var_deg),
        " ".join(str(int(d)) for d in code.chk_deg),
    ]
    for v in range(code.n_vars):
        nbrs = code.var_adj[v, code.var_mask[v]] + 1
        lines.append(" ".join(str(int(c)) for c in nbrs))
    for c in range(code.n_checks):
        nbrs = code.chk_adj[c, code.chk_mask[c]] + 1
        lines.append(" ".join(str(int(v)) for v in nbrs))
    Path(path).write_text("\n".join(lines) + "\n")
    if code.qc is not None:
        import json

        from qkd_ldpc_tpu_torch.codes.qc import qc_cells

        z, _, _, cells = qc_cells(code.qc)
        qc_sidecar_path(path).write_text(json.dumps({
            "format": "qkd_ldpc_tpu-qc-v1",
            "z": z,
            "cells": sorted([i, j, s] for (i, j), s in cells.items()),
        }))
    else:
        # Overwriting a previously-QC path with a non-QC code must not
        # leave the old sidecar behind: read_alist verifies sidecars
        # against the graph and would reject the fresh file as corrupt.
        qc_sidecar_path(path).unlink(missing_ok=True)
