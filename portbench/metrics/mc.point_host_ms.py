"""The host's own work a point (ms): the median, over the slice's points
(the program's ``qkd.point.run`` or ``qkd.cont.run`` spans), of the span
less the time its ``qkd.fetch.wait`` children cover."""

from portbench.metrics._spans import host_and_wait_ms


def read(run):
    r = host_and_wait_ms(run, ("qkd.point.run", "qkd.cont.run"), "qkd.fetch.wait")
    return None if r is None else r[0]
