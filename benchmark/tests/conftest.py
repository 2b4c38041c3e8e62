"""The benchmark's own tests (CPU, small sizes; the card's carry the `cuda`
marker and skip without one).  Run: python -m pytest benchmark/tests -q"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import env  # noqa: E402

env.prepare_process()


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
