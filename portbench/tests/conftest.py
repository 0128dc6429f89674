"""Tests of the benchmark. CPU tests run anywhere:

    python3 -m pytest -q portbench/tests

Tests marked ``cuda`` need an NVIDIA card and skip without one; on the card:

    python3 -m pytest -q -m cuda portbench/tests
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
