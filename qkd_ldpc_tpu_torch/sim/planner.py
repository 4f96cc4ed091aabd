"""QBER sweep planning from code rate.

Counterpart of ``qkd_ldpc_tpu/sim/planner.py``.  Mirrors ``get_rate_based_QBER_range`` (reference ``src/simulation.cpp:48-70``):
pick the *first* entry of the ascending-sorted rate table whose
``code_rate`` is >= the code's rate, and emit
``round((end - begin)/step)`` points ``begin + j*step`` (end-exclusive).
"""

from __future__ import annotations

import math
from typing import Sequence

from qkd_ldpc_tpu_torch.config import RQBERParams


def rate_based_qber_range(
    code_rate: float, table: Sequence[RQBERParams]
) -> list[float]:
    """QBER sweep points for a code of the given rate."""
    for entry in table:
        if code_rate <= entry.code_rate:
            # C++ round() = half-away-from-zero; Python round() is
            # banker's — use floor(x + 0.5) for positive arguments.
            steps = int(
                math.floor((entry.qber_end - entry.qber_begin) / entry.qber_step + 0.5)
            )
            qber = [entry.qber_begin + j * entry.qber_step for j in range(steps)]
            if not qber:
                break
            return qber
    raise ValueError(
        "An error occurred when generating a QBER range based on code rate."
    )
