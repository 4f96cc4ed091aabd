"""Console progress reporting.

Counterpart of ``qkd_ldpc_tpu/sim/progress.py`` and, like it, of the
reference's ``indicators::ProgressBar`` with elapsed and remaining time
(``src/simulation.cpp:202-215``), dependency-free.
"""

from __future__ import annotations

import sys
import time


def _hms(seconds: float) -> str:
    seconds = max(0, int(seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


class ProgressBar:
    """A minimal `[====>---] n/total elapsed/eta` stderr progress bar."""

    def __init__(self, total: int, width: int = 50, enabled: bool = True, label: str = "PROGRESS"):
        self.total = max(total, 1)
        self.width = width
        self.enabled = enabled and sys.stderr.isatty()
        self.label = label
        self.count = 0
        self.start = time.monotonic()
        self._last_render = 0.0

    def tick(self, n: int = 1) -> None:
        self.count += n
        now = time.monotonic()
        if not self.enabled:
            return
        if now - self._last_render < 0.1 and self.count < self.total:
            return
        self._last_render = now
        frac = min(self.count / self.total, 1.0)
        filled = int(frac * self.width)
        bar = "=" * filled + (">" if filled < self.width else "") + "-" * max(
            self.width - filled - 1, 0
        )
        elapsed = now - self.start
        eta = elapsed * (1 - frac) / frac if frac > 0 else 0.0
        sys.stderr.write(
            f"\r{self.label} [{bar}] {self.count}/{self.total} "
            f"elapsed {_hms(elapsed)} eta {_hms(eta)}"
        )
        sys.stderr.flush()

    def close(self) -> None:
        if self.enabled:
            sys.stderr.write("\n")
            sys.stderr.flush()
