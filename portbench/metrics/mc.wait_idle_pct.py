"""Share of the traced slice in which the device ran no operation while the
host was inside the program's ``qkd.fetch.wait`` (%): idle inside the
replayed graph, which the host's work cannot be blamed for."""

from portbench.metrics._spans import idle_inside_pct


def read(run):
    return idle_inside_pct(run, "qkd.fetch.wait")
