"""The Toeplitz product's share of its byte roofline (%): the bytes the
slice's blocks' privacy amplification needs (``arith_secure.toeplitz_bytes``:
the frames' payloads read once, the seed bits, the keys written once) over
the HBM peak and the device time of the kernels that ran inside the
program's ``qkd.secure.amplify`` spans (the endpoint has fetched the block's
decode and tags before the span opens, so nothing else runs there)."""

from portbench import arith, arith_secure
from portbench.metrics import _spans


def read(run):
    units = [u for u in run.units_in_slice() if "pa_bytes" in u]
    t = run.trace
    if t is None or not units:
        return None
    spans = _spans.in_slice(t, "qkd.secure.amplify")
    if not spans:
        return None
    busy = arith_secure.busy_inside(arith_secure.kernel_intervals(t), spans, t.lo, t.hi)
    if busy <= 0:
        return None
    return 100.0 * sum(u["pa_bytes"] for u in units) / arith.HBM_BYTES_PER_S / busy
