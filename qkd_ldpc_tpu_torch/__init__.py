"""qkd_ldpc_tpu_torch — PyTorch/CUDA port of qkd_ldpc_tpu for NVIDIA Hopper.

The port sits beside the JAX package and mirrors its module layout so a
reader finds each counterpart under the same name:

- config JSON (the reference's schema)                -> ``config``
- code ingest (alist + dense, native C++ loader) and
  construction                                        -> ``codes``
- threefry key tree + exact-weight binary channel     -> ``channel``
- syndrome-target BP decode, protocol step, rate
  adaptation, blind reconciliation, oracle            -> ``decoder``
- verification tags + privacy amplification           -> ``postprocess``
- the serving endpoint (Bob's side of the protocol)   -> ``serve``
- the three example programs (``python -m``)          -> ``examples``
- QBER sweep planning, runners, stats, CSV,
  checkpointing, interactive mode, console tracing    -> ``sim``
- trial meshes, sharded sweeps, node-sharded decode,
  process groups                                      -> ``parallel``
- command line (``python -m qkd_ldpc_tpu_torch``)     -> ``cli``
- hand-written CUDA kernels and their build           -> ``csrc``, ``_build``

Where the JAX package has a Pallas TPU kernel the port has a CUDA C++
kernel (``csrc/*.cu``) with a plain PyTorch version of the same function
beside its wrapper.  Entry points take ``device``; ``None`` means the
card and raises when there is none.
"""

from qkd_ldpc_tpu_torch.codes import (
    LDPCCode,
    load_code,
    make_code,
    make_qc_code,
    read_alist,
    read_dense,
)
from qkd_ldpc_tpu_torch.config import Config, load_config
from qkd_ldpc_tpu_torch.decoder import (
    DecodeOptions,
    DecodeResult,
    decode,
    reconcile,
    syndrome,
)
from qkd_ldpc_tpu_torch.postprocess import (
    amplified_key_bits,
    privacy_amplify,
    verification_tags,
)
from qkd_ldpc_tpu_torch.serve import Reconciler, SecureResult, ServeResult
from qkd_ldpc_tpu_torch.sim import run_point
from qkd_ldpc_tpu_torch.utils import resolve_device

__version__ = "0.1.0"

__all__ = [
    "Config",
    "load_config",
    "LDPCCode",
    "load_code",
    "read_alist",
    "read_dense",
    "make_code",
    "make_qc_code",
    "DecodeOptions",
    "DecodeResult",
    "decode",
    "reconcile",
    "syndrome",
    "run_point",
    "Reconciler",
    "ServeResult",
    "SecureResult",
    "verification_tags",
    "privacy_amplify",
    "amplified_key_bits",
    "resolve_device",
    "__version__",
]
