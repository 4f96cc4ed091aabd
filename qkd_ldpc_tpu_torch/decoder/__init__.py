"""Syndrome-target BP decoding (sum-product + normalized min-sum), rate
adaptation, blind reconciliation and the float64 oracle."""

from qkd_ldpc_tpu_torch.decoder.blind import (
    BlindResult,
    BlindSession,
    SecureBlindResult,
    blind_reconcile,
    blind_reconcile_sim,
)
from qkd_ldpc_tpu_torch.decoder.bp import (
    DecodeOptions,
    DecodeResult,
    bp_decode_batch_last,
    decode,
)
from qkd_ldpc_tpu_torch.decoder.layered import layered_decode_batch_last
from qkd_ldpc_tpu_torch.decoder.oracle import (
    OracleResult,
    oracle_decode,
    oracle_reconcile,
    oracle_syndrome,
)
from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateAdapter
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
    "layered_decode_batch_last",
    "syndrome",
    "apriori_llr",
    "reconcile",
    "reconcile_with_syndrome",
    "ReconcileResult",
    "RateAdapter",
    "BlindSession",
    "BlindResult",
    "SecureBlindResult",
    "blind_reconcile",
    "blind_reconcile_sim",
    "oracle_decode",
    "oracle_reconcile",
    "oracle_syndrome",
    "OracleResult",
]
