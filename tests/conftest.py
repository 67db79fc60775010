"""Pytest settings shared by the test files: the marker of tests that
need a CUDA card (they skip where none is present)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc (skips without them)")
