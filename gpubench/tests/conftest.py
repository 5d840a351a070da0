"""pytest settings of the benchmark's own tests (``gpubench/tests``): the
``cuda`` marker of tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (runs the benchmark on the card); skips without one",
    )
