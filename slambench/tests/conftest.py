"""The benchmark's own tests: on the CPU with the plain versions of the
program's kernels, at 64^3 and 160x120; a test that needs the card is
marked `cuda` and skips without one (decided inside the test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")
