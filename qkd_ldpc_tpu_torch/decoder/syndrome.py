"""GF(2) syndrome computation: s_c = XOR of the key bits at check c's
neighbours, as a masked gather + parity reduction (one path for regular
and irregular codes).  Counterpart of ``qkd_ldpc_tpu/decoder/syndrome.py``.
"""

from __future__ import annotations

import torch

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode


def syndrome(code: LDPCCode, bits: torch.Tensor) -> torch.Tensor:
    """Syndrome of ``bits`` [..., N] -> [..., M] int8, on the bits' device."""
    dev = code.to_device(bits.device)
    gathered = bits.to(torch.int32)[..., dev.chk_adj]  # [..., M, dc]
    gathered = torch.where(dev.chk_mask, gathered, 0)
    return (gathered.sum(dim=-1, dtype=torch.int32) & 1).to(torch.int8)
