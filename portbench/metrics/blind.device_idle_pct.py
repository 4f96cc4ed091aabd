"""Share of the traced slice in which the device ran no operation (%), in
the blind node's cell."""

from portbench.metrics._device import idle_pct


def read(run):
    return idle_pct(run)
