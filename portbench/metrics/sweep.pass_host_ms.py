"""The host's own work a sweep pass (ms): the median, over the slice's
passes, of the pass's ``qkd.sweep.run`` plus the ``qkd.sweep.write`` after
it (before the next pass), less the ``qkd.fetch.wait`` spans inside them."""

import statistics

from portbench.metrics import _spans


def read(run):
    t = run.trace
    if t is None:
        return None
    passes = _spans.in_slice(t, "qkd.sweep.run")
    if not passes:
        return None
    writes = _spans.in_slice(t, "qkd.sweep.write")
    waits = _spans.in_slice(t, "qkd.fetch.wait")
    host = []
    for k, (s, e) in enumerate(passes):
        parts = [(s, e)]
        nxt = passes[k + 1][0] if k + 1 < len(passes) else float("inf")
        parts += [w for w in writes if e <= w[0] < nxt][:1]
        host.append(sum(b - a - _spans.covered(waits, a, b) for a, b in parts))
    return 1e3 * statistics.median(host)
