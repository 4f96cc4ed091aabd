"""How long the host blocks on the card a block (ms): the median, over the
slice's ``qkd.serve.reconcile`` spans, of the time their ``qkd.serve.wait``
children cover."""

from portbench.metrics._spans import host_and_wait_ms


def read(run):
    r = host_and_wait_ms(run, ("qkd.serve.reconcile",), "qkd.serve.wait")
    return None if r is None else r[1]
