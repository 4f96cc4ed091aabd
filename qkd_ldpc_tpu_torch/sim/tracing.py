"""Hierarchical console tracing (the reference's three trace flags).

Counterpart of ``qkd_ldpc_tpu/sim/tracing.py``.  The reference prints decoder internals from inside its hot loop, gated by
three config booleans (SURVEY.md §5 "Tracing / profiling"):

- ``TRACE_QKD_LDPC``        — protocol level: a-priori LLRs ``r``, Alice's
  syndrome, the corrected key (``src/qkd_ldpc_algorithm.cpp:356-389``)
- ``TRACE_SUM_PRODUCT``     — per iteration: check→bit messages ``E``,
  totals ``L``, decisions ``z``, decision syndrome ``s``, bit→check
  messages ``M`` (``:42-45,78-82,97-111,145-149``)
- ``TRACE_SUM_PRODUCT_LLR`` — running max |LLR| over both message
  matrices (``:115-118,150-155,160-163``)

Trace prints must never enter the compiled device path, so traced
decodes run on the host float64 oracle (``decoder.oracle``) instead — the
same equations in the reference's own division form, with hook points for
every quantity above.  This module formats those hooks into the
reference-style console dump and drives a traced single-frame protocol
step (used by interactive mode and the example program).

Caveat, inherited deliberately: the oracle carries the reference's
division-form numerics, which NaN on exactly-zero messages (PARITY.md
"Known deliberate divergence") — a traced frame with an erasure LLR
shows the NaN cascade the reference itself would print, while the
compiled decoder recovers the frame.  Traces are a debugging view of
reference behavior, not of the production decode path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.config import Config
from qkd_ldpc_tpu_torch.decoder.oracle import oracle_reconcile


@dataclasses.dataclass(frozen=True)
class TraceFlags:
    """Which trace levels are active (reference ``config.hpp:34-36``)."""

    qkd_ldpc: bool = False
    sum_product: bool = False
    sum_product_llr: bool = False

    @classmethod
    def from_config(cls, cfg: Config) -> "TraceFlags":
        return cls(
            qkd_ldpc=cfg.trace_qkd_ldpc,
            sum_product=cfg.trace_sum_product,
            sum_product_llr=cfg.trace_sum_product_llr,
        )

    @property
    def any(self) -> bool:
        return self.qkd_ldpc or self.sum_product or self.sum_product_llr


_PROTOCOL_TAGS = {
    "r": "Array of a priori log likelihood ratios (r)",
    "alice_syndrome": "Alice syndrome (s_A)",
    "corrected_key": "Corrected bit array (Bob's decoded key)",
}
_ITER_TAGS = {
    "E": "Matrix of check-to-bit messages (E)",
    "L": "Array of total log likelihood ratios (L)",
    "z": "Array of bit decisions (z)",
    "s": "Decision syndrome (s)",
    "M": "Matrix of bit-to-check messages (M)",
}


def _fmt(arr: np.ndarray) -> str:
    arr = np.asarray(arr)
    if arr.ndim <= 1:
        if np.issubdtype(arr.dtype, np.floating):
            return "[" + ", ".join(f"{x:.4g}" for x in arr) + "]"
        return "[" + ", ".join(str(int(x)) for x in arr) + "]"
    # Per-node rows; NaN marks padded slots of irregular codes.
    lines = []
    for row in arr:
        vals = [f"{x:.4g}" for x in row[~np.isnan(row)]]
        lines.append("  [" + ", ".join(vals) + "]")
    return "\n" + "\n".join(lines)


class ConsoleTracer:
    """Formats oracle trace hooks as the reference-style console dump.

    Pass as the ``trace`` callback of :func:`decoder.oracle.oracle_decode`
    / :func:`oracle_reconcile`; tags it does not recognize are printed
    verbatim (forward-compatible).
    """

    def __init__(self, flags: TraceFlags, print_fn: Callable[[str], None] = print):
        self.flags = flags
        self.print = print_fn
        self._iteration = 0
        self._max_abs = 0.0

    def __call__(self, tag: str, arr: np.ndarray) -> None:
        if tag in _PROTOCOL_TAGS:
            if self.flags.qkd_ldpc:
                self.print(f"{_PROTOCOL_TAGS[tag]}: {_fmt(arr)}")
            return
        if tag == "E":  # first tag of each iteration
            self._iteration += 1
            if self.flags.sum_product:
                self.print(f"Iteration: {self._iteration}")
        if tag in _ITER_TAGS:
            if self.flags.sum_product:
                self.print(f"{_ITER_TAGS[tag]}: {_fmt(arr)}")
            if self.flags.sum_product_llr and tag in ("E", "M"):
                a = np.asarray(arr, float)
                self._max_abs = max(
                    self._max_abs, float(np.nanmax(np.abs(a), initial=0.0))
                )
                self.print(f"MAX ABS LLR: {self._max_abs:.6g}")
            return
        self.print(f"{tag}: {_fmt(arr)}")  # unknown tag: verbatim


def traced_reconcile(
    code: LDPCCode,
    alice_bits: np.ndarray,
    bob_bits: np.ndarray,
    qber: float,
    *,
    max_iterations: int = 100,
    clip_messages: bool = True,
    message_threshold: float = 100.0,
    flags: TraceFlags = TraceFlags(True, True, True),
    print_fn: Callable[[str], None] = print,
):
    """Single-frame protocol step with reference-style console traces.

    Runs on the host f64 oracle (never the compiled device path); returns
    ``(OracleResult, keys_match)``.
    """
    tracer = ConsoleTracer(flags, print_fn)
    res, keys_match = oracle_reconcile(
        code,
        np.asarray(alice_bits),
        np.asarray(bob_bits),
        qber,
        max_iterations=max_iterations,
        clip_messages=clip_messages,
        message_threshold=message_threshold,
        trace=tracer if flags.any else None,
    )
    if flags.qkd_ldpc:
        verdict = "MATCH" if keys_match else "MISMATCH"
        print_fn(
            f"Iterations: {res.iterations}; syndromes "
            f"{'converged' if res.syndromes_match else 'did NOT converge'}; "
            f"keys {verdict}"
        )
    return res, keys_match
