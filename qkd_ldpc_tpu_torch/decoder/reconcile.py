"""QKD information-reconciliation protocol step.

Counterpart of ``qkd_ldpc_tpu/decoder/reconcile.py``: build a-priori LLRs
from Bob's noisy key and the channel QBER, compute Alice's syndrome, run
syndrome-target BP decoding of Bob's key toward it, and (simulation-only
oracle) verify the corrected key against Alice's.
``reconcile_with_syndrome`` is the deployable Bob-side API, ``reconcile``
the simulation convenience that also plays Alice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, DecodeResult, decode
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
from qkd_ldpc_tpu_torch.utils import resolve_device


class ReconcileResult(NamedTuple):
    bits: torch.Tensor  # [B, N] corrected key (Bob's solution)
    iterations: torch.Tensor  # [B] int32
    syndromes_match: torch.Tensor  # [B] bool (SP convergence)
    keys_match: torch.Tensor  # [B] bool (oracle check vs Alice)


def apriori_llr(bob_bits: torch.Tensor, qber) -> torch.Tensor:
    """A-priori LLRs (float32): +log((1-q)/q) for bit 0, negative for bit 1.

    The value is computed once on the host: the ratio in float32 (as the
    JAX package forms it), its ``log`` in float64 rounded to float32 — the
    correctly rounded result, independent of any device's ``log``.  XLA's
    CPU ``log`` is an approximation that lands one ulp off this value for
    about 3% of ratios, numpy's float32 ``log`` and ``torch.log`` likewise
    (each on other ratios), so no choice reproduces the JAX package's LLR
    magnitude at every QBER; the tests hold the port to the QBERs they
    use.  A per-frame ``qber`` [B] broadcasts over the bits.
    """
    q = np.asarray(qber, dtype=np.float32)
    ratio = (np.float32(1.0) - q) / q
    log_p = np.log(ratio.astype(np.float64)).astype(np.float32)
    log_p = torch.as_tensor(log_p, device=bob_bits.device)
    if log_p.ndim == 1:
        log_p = log_p[:, None]
    return torch.where(bob_bits == 1, -log_p, log_p)


def reconcile_with_syndrome(
    code: LDPCCode,
    bob_bits,  # [B, N] or [N]
    alice_syndrome,  # [B, M] or [M]
    qber,
    opts: DecodeOptions = DecodeOptions(),
    device=None,
) -> DecodeResult:
    """Bob-side reconciliation: decode the noisy key toward Alice's syndrome."""
    device = resolve_device(device)
    llr = apriori_llr(torch.as_tensor(bob_bits).to(device), qber)
    return decode(code, llr, alice_syndrome, opts, device=device)


def reconcile(
    code: LDPCCode,
    alice_bits,  # [B, N] or [N]
    bob_bits,
    qber,
    opts: DecodeOptions = DecodeOptions(),
    device=None,
) -> ReconcileResult:
    """Full simulated protocol step with the keys-match oracle check (it
    detects frames whose syndromes converge on a wrong key)."""
    device = resolve_device(device)
    alice_bits = torch.as_tensor(alice_bits).to(device)
    alice_syn = syndrome(code, alice_bits)
    res = reconcile_with_syndrome(code, bob_bits, alice_syn, qber, opts, device)
    keys_match = (res.bits == alice_bits.to(torch.int8)).all(dim=-1)
    return ReconcileResult(
        bits=res.bits,
        iterations=res.iterations,
        syndromes_match=res.syndromes_match,
        keys_match=keys_match,
    )
