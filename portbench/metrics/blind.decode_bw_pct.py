"""Bytes the decode of the slice's blocks needed, over the HBM peak and the
device time of the flooding decode's kernels (K1, K2, KV) in the slice (%):
``ra.decode_bw_pct``'s reading, on the blind endpoint's frame-iterations (a
frame's iterations, the cap for a frame that did not converge, over every
round of the block)."""

from portbench import spec


def read(run):
    return spec.reader("ra.decode_bw_pct", run.ctx.base)(run)
