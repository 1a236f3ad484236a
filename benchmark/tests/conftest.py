"""The benchmark's own tests.  Run from the root of the checkout:

    python -m pytest benchmark/tests -q

Tests marked `card` need an NVIDIA GPU; each decides inside its fixture and
skips without one.  On the card they run as

    python -m pytest benchmark/tests -q -m card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")
