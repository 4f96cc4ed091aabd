"""qkd_ldpc_tpu_torch — PyTorch/CUDA port of qkd_ldpc_tpu for NVIDIA Hopper.

The port sits beside the JAX package and mirrors its module layout so a
reader finds each counterpart under the same name:

- code construction (numpy only)                      -> ``codes``
- threefry key tree + exact-weight binary channel     -> ``channel``
- syndrome-target flooding BP decode, protocol step   -> ``decoder``
- statistics and the Monte-Carlo point runner         -> ``sim``
- hand-written CUDA kernels and their build           -> ``csrc``, ``_build``

Where the JAX package has a Pallas TPU kernel the port has a CUDA C++
kernel (``csrc/*.cu``) with a plain PyTorch version of the same function
beside its wrapper.  Entry points take ``device``; ``None`` means the
card and raises when there is none.
"""

from qkd_ldpc_tpu_torch.codes import LDPCCode, make_code, make_qc_code
from qkd_ldpc_tpu_torch.decoder import (
    DecodeOptions,
    DecodeResult,
    decode,
    reconcile,
    syndrome,
)
from qkd_ldpc_tpu_torch.sim import run_point
from qkd_ldpc_tpu_torch.utils import resolve_device

__version__ = "0.1.0"

__all__ = [
    "LDPCCode",
    "make_code",
    "make_qc_code",
    "DecodeOptions",
    "DecodeResult",
    "decode",
    "reconcile",
    "syndrome",
    "run_point",
    "resolve_device",
    "__version__",
]
