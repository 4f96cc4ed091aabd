"""Share of the traced slice in which the device ran no operation while the
host was inside the program's ``qkd.graph.replay`` (%): idle the graph's
launch causes."""

from portbench.metrics._spans import idle_inside_pct


def read(run):
    return idle_inside_pct(run, "qkd.graph.replay")
