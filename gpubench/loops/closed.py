"""``loop: closed``: one client that sends its next call of ``batch`` queries
when the last is answered, while the window lasts; the window closes when
the last call ends. Warm-up makes one call."""

from __future__ import annotations

import sys
import time
from contextlib import nullcontext

import numpy as np

from gpubench.gen.arrivals import query_order
from gpubench.loops import Window, k1_launches


class Loop:
    def __init__(self, system, traffic: dict, pool: np.ndarray, seed: int, seconds: float):
        self.system, self.pool, self.seconds = system, pool, seconds
        self.batch = traffic["batch"]
        self.perm = query_order(len(pool), len(pool), seed)

    def _queries(self, j: int) -> np.ndarray:
        return self.perm[(j * self.batch + np.arange(self.batch)) % len(self.pool)]

    def warm(self) -> None:
        self.system.call(self.pool[self._queries(0)])

    def run(self, span=nullcontext) -> Window:
        w = Window()
        self.system.calls.clear()
        before = k1_launches()
        with span():
            w.t0 = t0 = time.perf_counter()
            j = 0
            while time.perf_counter() - t0 < self.seconds:
                q = self._queries(j)
                w.attempted += len(q)
                try:
                    vals, ids = self.system.call(self.pool[q])
                except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
                    print(f"gpubench: call {j} failed: {e!r}", file=sys.stderr)
                    w.failed += len(q)
                else:
                    w.qidx.extend(q)
                    w.vals.extend(vals)
                    w.ids.extend(ids)
                j += 1
            w.t_end = time.perf_counter()
        w.counters = {"k1_launches": k1_launches() - before}
        return w

    def close(self) -> None:
        pass
