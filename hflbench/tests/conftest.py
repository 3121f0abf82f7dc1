"""The benchmark's tests: ``chip`` marks a test that needs a CUDA device; such
a test decides inside itself whether one is there and skips without it."""


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skips without one)")
