import os
import sys

# smoke tests and benches must see ONE device (the dry-run sets its own
# XLA_FLAGS in-process); tests that need many host devices spawn
# subprocesses (see test_distributed.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")
