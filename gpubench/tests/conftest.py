"""CPU tests of the benchmark harness: cells shrunk to a tiny size run the
whole harness with the port's plain versions; tests that need the card are
marked ``cuda`` and skip elsewhere."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_ROWS = {"batch": 12_000, "segmented": 16_000}


def tiny(cell, rows=None, seconds_rate=300.0):
    """``cell`` at a size the CPU runs in about a second: its configuration
    with few rows and a 64-query pool, an open loop at ``seconds_rate``, a
    closed loop's batch at most 64. Widths, metric and k stay."""
    cell = copy.deepcopy(cell)
    cfg = cell.config
    cfg.update(rows=rows or TINY_ROWS[cfg["index"]], queries=64, check_queries=48)
    if cell.traffic["loop"] == "open":
        cell.traffic["rate_per_s"] = seconds_rate
    else:
        cell.traffic["batch"] = min(cell.traffic["batch"], 64)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
