"""A block's privacy amplification (ms): the median, over the slice's
``qkd.secure.amplify`` spans of the program (the product and the fetch of
the block's keys), of their length."""

import statistics

from portbench.metrics import _spans


def read(run):
    if run.trace is None:
        return None
    spans = _spans.in_slice(run.trace, "qkd.secure.amplify")
    if not spans:
        return None
    return 1e3 * statistics.median(e - s for s, e in spans)
