import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

try:
    import hypothesis  # noqa: F401
except ImportError:
    # Optional dev dependency (requirements-dev.txt); fall back to the
    # deterministic stub so the property-test modules still collect + run.
    import _hypothesis_stub

    _hypothesis_stub.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
