"""The benchmark's own tests. ``card``: tests that need an NVIDIA card;
each decides inside itself whether one is present and skips otherwise."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
