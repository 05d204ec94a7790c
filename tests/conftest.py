import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running integration tests (subprocess compiles)")
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
