"""pytest settings of the benchmark's own tests (`pytest benchmark/tests`).

`card` marks a test that needs an NVIDIA GPU; it decides inside the test
whether there is one and skips on a machine without it."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (runs the cell's own sizes); skips without one")
