"""What a run hands the metric readers (``gpubench/metrics/<name>.py``).

A reader is ``read(record) -> float | None``: None where it finds nothing
to read, and the metric is then left out of the result line. The helpers
below hold the arithmetic that several readers share."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gpubench.roofline import call_bound_s
from gpubench.trace import Trace


@dataclass
class Record:
    cell: str
    config: dict
    traffic: dict
    cards: int
    setup_s: float
    window: object  # gpubench.loops.Window
    calls: list  # gpubench.system.Call, the window's calls
    trace: Trace | None = None


def percentile_ms(rec: Record, q: float):
    lat = rec.window.latencies_ms
    return None if lat is None or len(lat) == 0 else float(np.percentile(lat, q))


def k1_roofline_pct(rec: Record):
    """The window's calls' bound over K1's device time, in percent."""
    if rec.trace is None or not rec.calls:
        return None
    k1 = rec.trace.k1_s()
    if k1 <= 0:
        return None
    bound = sum(call_bound_s(rec.config, c.n) for c in rec.calls)
    return 100.0 * bound / k1


def idle_share(rec: Record):
    """1 - the union of a card's device intervals over the traced window,
    the mean over the run's cards."""
    if rec.trace is None or rec.trace.window_s <= 0 or not rec.trace.device:
        return None
    return 1.0 - rec.trace.mean_busy_s(rec.cards) / rec.trace.window_s
