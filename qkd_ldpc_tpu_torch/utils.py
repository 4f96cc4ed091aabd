"""Device resolution and card identification for the PyTorch/CUDA port.

Counterpart of ``qkd_ldpc_tpu/utils.py`` for the part the port needs: the
JAX package picks its backend through ``jax.default_backend()``; here
every entry point takes an explicit ``device`` and resolves it with
:func:`resolve_device`.  ``None`` means the card and raises when there is
none — no path carries on on the CPU because it found no GPU.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them.

    A card set below its maximum power limit runs slower under load, so
    every timing is labelled with this line.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]
