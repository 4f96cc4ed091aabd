"""Share of the traced slice in which the device ran no operation (%)."""

from portbench.metrics._device import idle_pct


def read(run):
    return idle_pct(run)
