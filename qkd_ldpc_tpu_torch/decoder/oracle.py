"""NumPy float64 oracle decoder (host-side, tests + tracing).

Counterpart of ``qkd_ldpc_tpu/decoder/oracle.py``, a copy that keeps the
traces byte-identical.  An independent, vectorized re-implementation of the
tanh-rule equations the reference evaluates in double precision
(``src/qkd_ldpc_algorithm.cpp:40-158``), used as a known-good oracle for the
float32 device decoder and as the backing engine for hierarchical console
traces (the reference's ``TRACE_SUM_PRODUCT`` / ``TRACE_QKD_LDPC`` /
``TRACE_SUM_PRODUCT_LLR`` flags print from inside the hot loop; trace prints
must stay out of the device path's kernels, so trace runs use this host
decoder instead).

It uses the same leave-one-out-by-division form as the reference
(row_prod / tanh_j, qkd_ldpc_algorithm.cpp:67) to reproduce its numerics
as closely as possible, including message-threshold clipping placement.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode


class OracleResult(NamedTuple):
    bits: np.ndarray  # [N] int
    iterations: int
    syndromes_match: bool
    max_abs_llr: float  # running max |message| (TRACE_SUM_PRODUCT_LLR analog)


def oracle_syndrome(code: LDPCCode, bits: np.ndarray) -> np.ndarray:
    g = np.where(code.chk_mask, bits[code.chk_adj], 0)
    return (g.sum(axis=1) & 1).astype(np.int64)


def oracle_decode(
    code: LDPCCode,
    llr: np.ndarray,  # [N] float64 a-priori LLRs
    target_syndrome: np.ndarray,  # [M] 0/1
    max_iterations: int = 100,
    clip_messages: bool = True,
    message_threshold: float = 100.0,
    trace: Callable[[str, np.ndarray], None] | None = None,
) -> OracleResult:
    """Single-frame double-precision syndrome-target sum-product decode."""
    llr = np.asarray(llr, np.float64)
    M, dc = code.chk_adj.shape
    N, dv = code.var_adj.shape
    cmask = code.chk_mask
    vmask = code.var_mask

    # Check-major bit->check messages, initialized from the a-priori LLRs.
    Lq = np.where(cmask, llr[code.chk_adj], 0.0)
    syn_sign = np.where(np.asarray(target_syndrome) == 1, -1.0, 1.0)

    # Defined result for max_iterations == 0: a-priori hard decisions.
    z = (llr <= 0).astype(np.int64)
    max_abs = 0.0
    it = 0
    while it < max_iterations:
        t = np.tanh(Lq / 2.0)
        t = np.where(cmask, t, 1.0)
        row_prod = syn_sign * t.prod(axis=1)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            q = row_prod[:, None] / t
            Lr_chk = 2.0 * np.arctanh(q)
        if clip_messages:
            Lr_chk = np.clip(Lr_chk, -message_threshold, message_threshold)

        # Route to variable-major via the precomputed permutation.
        flat = np.append(Lr_chk.reshape(-1), 0.0)
        Lr_var = flat[code.var_slot]
        if trace is not None:
            trace("E", np.where(vmask, Lr_var, np.nan))

        total = llr + Lr_var.sum(axis=1)
        z = (total <= 0).astype(np.int64)
        if trace is not None:
            trace("L", total)
            trace("z", z)

        syn_hat = oracle_syndrome(code, z)
        if trace is not None:
            trace("s", syn_hat)
        if np.array_equal(syn_hat, np.asarray(target_syndrome)):
            return OracleResult(z, it + 1, True, max_abs)

        Lq_var = total[:, None] - Lr_var
        flat_v = np.append(Lq_var.reshape(-1), 0.0)
        Lq = flat_v[code.chk_slot]
        if clip_messages:
            Lq = np.clip(Lq, -message_threshold, message_threshold)
        if trace is not None:
            trace("M", np.where(cmask, Lq, np.nan))

        max_abs = max(
            max_abs,
            float(np.abs(np.where(vmask, Lr_var, 0.0)).max()),
            float(np.abs(np.where(cmask, Lq, 0.0)).max()),
        )
        it += 1

    return OracleResult(z, max_iterations, False, max_abs)


def oracle_reconcile(
    code: LDPCCode,
    alice_bits: np.ndarray,
    bob_bits: np.ndarray,
    qber: float,
    max_iterations: int = 100,
    clip_messages: bool = True,
    message_threshold: float = 100.0,
    trace: Callable[[str, np.ndarray], None] | None = None,
):
    """Host-side protocol step: returns (OracleResult, keys_match)."""
    log_p = np.log((1.0 - qber) / qber)
    llr = np.where(np.asarray(bob_bits) == 1, -log_p, log_p)
    if trace is not None:
        trace("r", llr)
    syn = oracle_syndrome(code, np.asarray(alice_bits))
    if trace is not None:
        trace("alice_syndrome", syn)
    res = oracle_decode(
        code, llr, syn, max_iterations, clip_messages, message_threshold, trace
    )
    keys_match = bool(np.array_equal(res.bits, np.asarray(alice_bits)))
    if trace is not None:
        trace("corrected_key", res.bits)
    return res, keys_match
