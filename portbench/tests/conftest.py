"""The benchmark's own tests: `python -m pytest portbench/tests -q` on
the CPU; those marked `cuda` run on the card (`python -m pytest
portbench/tests -q -m cuda` there, from the root of a checkout)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs on the card; skips "
        "elsewhere)")
