"""Code ingest and construction: the LDPCCode graph container, the alist and
dense parsers (with the native C++ loader), and the two generators.

Counterpart of ``qkd_ldpc_tpu/codes`` and, like it, of the reference's
``array_and_matrix_operations`` ingest layer
(``src/array_and_matrix_operations.cpp:109-421``).
"""

from __future__ import annotations

from pathlib import Path

from qkd_ldpc_tpu_torch.codes.alist import parse_alist, read_alist, write_alist
from qkd_ldpc_tpu_torch.codes.dense import parse_dense, read_dense, write_dense
from qkd_ldpc_tpu_torch.codes.generate import make_code
from qkd_ldpc_tpu_torch.codes.ldpc_code import (
    DeviceCode,
    LDPCCode,
    code_from_numpy,
    from_check_adjacency,
    from_dense,
)
from qkd_ldpc_tpu_torch.codes.qc import make_qc_code


def load_code(path: str | Path, dense: bool | None = None) -> LDPCCode:
    """Load a code file, auto-detecting format unless ``dense`` is given.

    Detection: an alist file's first line has exactly two integers N M with
    N, M > 1 and the second line two integers; a dense file's rows are 0/1.
    """
    path = Path(path)
    if dense is None:
        first = path.read_text().lstrip().splitlines()[0].split()
        dense = all(tok in ("0", "1") for tok in first)
    return read_dense(path) if dense else read_alist(path)


def list_matrix_files(directory: str | Path) -> list[Path]:
    """Enumerate matrix files in a directory, sorted by name (QC sidecars
    skipped).

    Counterpart of the reference's ``get_file_paths_in_directory``
    (``src/utils.cpp:20-47``).
    """
    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"Directory does not exist: {directory}")
    return sorted(
        p for p in directory.iterdir()
        if p.is_file() and not p.name.endswith(".qc.json")  # QC sidecars
    )


__all__ = [
    "DeviceCode",
    "LDPCCode",
    "code_from_numpy",
    "from_check_adjacency",
    "from_dense",
    "parse_alist",
    "read_alist",
    "write_alist",
    "parse_dense",
    "read_dense",
    "write_dense",
    "make_code",
    "make_qc_code",
    "load_code",
    "list_matrix_files",
]
