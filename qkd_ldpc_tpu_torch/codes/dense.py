"""Dense 0/1 parity-check-matrix reader and writer.

Counterpart of ``qkd_ldpc_tpu/codes/dense.py``.  Mirrors the validation semantics of the reference's ``read_dense_matrix``
(``src/array_and_matrix_operations.cpp:295-421``): whitespace-separated 0/1
rows, non-binary values and ragged rows rejected, zero-weight rows/columns
rejected.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode, from_dense


def parse_dense(text: str, path: str = "<string>", name: str = "") -> LDPCCode:
    """Parse whitespace-separated 0/1 rows into an :class:`LDPCCode`."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"File is empty or cannot be read properly: {path}")
    rows = []
    for ln in lines:
        try:
            row = [int(tok) for tok in ln.split()]
        except ValueError as e:
            raise ValueError(f"An error occurred while parsing file: {path}") from e
        for x in row:
            if x not in (0, 1):
                raise ValueError("Parity check matrix can only take values 0 or 1.")
        rows.append(row)
    width = len(rows[0])
    for row in rows:
        if len(row) != width:
            raise ValueError(f"Different lengths of rows in a matrix. File: {path}")
    return from_dense(np.array(rows, dtype=np.uint8), name=name)


def read_dense(path: str | Path) -> LDPCCode:
    """Read a dense-format matrix file into an :class:`LDPCCode`."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Failed to open file: {path}")
    return parse_dense(path.read_text(), str(path), name=path.name)


def write_dense(code: LDPCCode, path: str | Path) -> None:
    """Write a code as whitespace-separated dense 0/1 rows."""
    H = code.dense
    lines = [" ".join(str(int(x)) for x in row) for row in H]
    Path(path).write_text("\n".join(lines) + "\n")
