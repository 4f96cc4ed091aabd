"""A blind round's turn (ms): the median, over the slice's
``qkd.blind.turn`` spans of the program (from a round's last fetch to the
next round's first fill: the frames left, the request, Alice's answer and
her bits taken in), of their length."""

import statistics

from portbench.metrics import _spans


def read(run):
    if run.trace is None:
        return None
    spans = _spans.in_slice(run.trace, "qkd.blind.turn")
    if not spans:
        return None
    return 1e3 * statistics.median(e - s for s, e in spans)
