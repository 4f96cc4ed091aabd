"""Syndrome-target BP decoding: sum-product + normalized min-sum."""

from qkd_ldpc_tpu_torch.decoder.bp import (
    DecodeOptions,
    DecodeResult,
    bp_decode_batch_last,
    decode,
)
from qkd_ldpc_tpu_torch.decoder.reconcile import (
    ReconcileResult,
    apriori_llr,
    reconcile,
    reconcile_with_syndrome,
)
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome

__all__ = [
    "DecodeOptions",
    "DecodeResult",
    "decode",
    "bp_decode_batch_last",
    "syndrome",
    "apriori_llr",
    "reconcile",
    "reconcile_with_syndrome",
    "ReconcileResult",
]
