"""Console helpers, device resolution and card identification.

Counterpart of ``qkd_ldpc_tpu/utils.py``.  The console helpers reproduce the
reference's color scheme (``src/utils.{hpp,cpp}``: green = status,
purple/magenta = mode banners, red = errors, blue = traces) with plain ANSI,
honoring ``NO_COLOR`` and non-TTY streams.  The JAX package's persistent
compilation cache has no counterpart: the CUDA libraries are already cached
by source hash in ``_build/``.

The JAX package picks its backend through ``jax.default_backend()``; here
every entry point takes an explicit ``device`` and resolves it with
:func:`resolve_device`.  ``None`` means the card and raises when there is
none — no path carries on on the CPU because it found no GPU.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

_CODES = {
    "green": "\x1b[32m",
    "magenta": "\x1b[35m",
    "red": "\x1b[31m",
    "blue": "\x1b[34m",
}
_RESET = "\x1b[0m"


def _want_color(stream) -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    return hasattr(stream, "isatty") and stream.isatty()


def colorize(text: str, color: str, stream=None) -> str:
    """Wrap ``text`` in an ANSI color when the stream is a color TTY."""
    stream = stream if stream is not None else sys.stdout
    if not _want_color(stream):
        return text
    return f"{_CODES[color]}{text}{_RESET}"


def print_status(text: str) -> None:
    print(colorize(text, "green"))


def print_mode(text: str) -> None:
    print(colorize(text, "magenta"))


def print_error(text: str) -> None:
    print(colorize(text, "red", sys.stderr), file=sys.stderr)


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


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in: ``cuda`` becomes ``cuda:<current
    card>``, so ``cuda`` and ``cuda:0`` name one card in a cache key or a
    mesh.  Other devices come back as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def tensor_on(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device`` is
    given; anything else (numpy, lists) goes to :func:`resolve_device`'s
    device.  ``dtype`` converts."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype).to(resolve_device(device))


def host(x, dtype=None) -> np.ndarray:
    """``x`` as a numpy array on the host (a tensor is fetched from its
    device); ``dtype`` converts."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=dtype)


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
