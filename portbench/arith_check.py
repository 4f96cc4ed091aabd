"""The bytes the flooding check update needs, the yardstick of its roofline
share (``mc.check_bw_pct``).

Per frame-iteration, each counted once at the program's own widths: the
variables' totals read (storage width), every edge message read and written
(storage width) and one syndrome byte a check read.  The edges are the
code's own, so slots padded to the widest row count nothing.
"""

from __future__ import annotations

from portbench.arith import STORAGE_BYTES

# the check update's kernels, the unrolled degrees' and the loop instance's
# (csrc/check_update.cu); a name holds one of these
CHECK_KERNELS = ("check_update_kernel", "check_update_any_kernel")


def check_bytes_per_frame_iteration(n_vars: int, n_checks: int, n_edges: int,
                                    storage: str) -> int:
    w = STORAGE_BYTES[storage]
    return w * n_vars + 2 * w * n_edges + n_checks
