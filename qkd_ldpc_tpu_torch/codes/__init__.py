"""Code construction: the LDPCCode graph container and the two generators.

Counterpart of ``qkd_ldpc_tpu/codes``.  The alist/dense parsers and the
native graph builder are not ported yet.
"""

from qkd_ldpc_tpu_torch.codes.generate import make_code
from qkd_ldpc_tpu_torch.codes.ldpc_code import (
    DeviceCode,
    LDPCCode,
    code_from_numpy,
    from_check_adjacency,
    from_dense,
)
from qkd_ldpc_tpu_torch.codes.qc import make_qc_code

__all__ = [
    "DeviceCode",
    "LDPCCode",
    "code_from_numpy",
    "from_check_adjacency",
    "from_dense",
    "make_code",
    "make_qc_code",
]
