"""The host's own work a block (ms): the median, over the slice's
``qkd.serve.reconcile`` spans, of the span less its ``qkd.serve.wait``
children (the chunks' fill, dispatch and read)."""

from portbench.metrics._spans import host_and_wait_ms


def read(run):
    r = host_and_wait_ms(run, ("qkd.serve.reconcile",), "qkd.serve.wait")
    return None if r is None else r[0]
