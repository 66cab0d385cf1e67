"""The loops a traffic mix can ask for, one module each, found by the mix's
``loop`` (:func:`gpubench.bench.loop`): ``gpubench/loops/<loop>.py`` defines
``Loop(system, traffic, pool, seed, seconds)`` with

- ``warm()``: every shape the window will use, before it (set-up);
- ``run(span) -> Window``: the measured window, inside ``span()``, keeping
  every answer as ``(pool index, values, ids)``;
- ``close()``: stops whatever the loop started.

This module holds what the loops share.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DRAIN_S = 60.0  # how long past the window an answer is waited for


@dataclass
class Window:
    """What a window produced."""

    t0: float = 0.0
    t_end: float = 0.0
    attempted: int = 0
    failed: int = 0
    qidx: list = field(default_factory=list)
    vals: list = field(default_factory=list)
    ids: list = field(default_factory=list)
    latencies_ms: np.ndarray | None = None
    lateness_ms: np.ndarray | None = None
    counters: dict = field(default_factory=dict)


def k1_launches() -> int:
    """K1 passes launched so far (``innr_tpu_torch.kernels.knn.LAUNCHES``)."""
    from innr_tpu_torch.kernels import knn

    return knn.LAUNCHES
