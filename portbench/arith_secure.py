"""The secure chain's yardstick arithmetic: the bytes a Toeplitz hash needs,
and device time of chosen operations in a traced slice.

The hash of ``frames`` frames of ``n_in`` bits to ``n_out`` bits needs, each
counted once at one byte a bit (the program's own input and output width):
the frames read, the ``n_in + n_out - 1`` seed bits read and the hashes
written.  Bytes bound the hash however it is computed (a dense product, an
FFT, a bit-packed product), so its share of the byte roofline stays below
100 % for any of them.
"""

from __future__ import annotations

from portbench import arith

# device operations that move memory between host and card: no kernel's time
COPIES = ("Memcpy", "Memset")


def toeplitz_bytes(frames: int, n_in: int, n_out: int) -> int:
    return frames * n_in + (n_in + n_out - 1) + frames * n_out


def kernel_intervals(trace, *parts) -> list[tuple[float, float]]:
    """``(start, end)`` of the slice's device kernels whose names hold one of
    ``parts`` (every kernel where none is given; copies never)."""
    return [(s, e) for s, e, n in trace.device
            if not n.startswith(COPIES) and (not parts or any(p in n for p in parts))]


def busy_inside(intervals, spans, lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` in which some interval is open while some
    span is: the overlap of the two unions."""
    a, b = arith.union(intervals, lo, hi), arith.union(spans, lo, hi)
    i = j = 0
    t = 0.0
    while i < len(a) and j < len(b):
        t += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return t
