"""pytest settings of the benchmark's own tests (``pytest portbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where there is none (run on the chip)")
