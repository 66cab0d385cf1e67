"""``loop: open``: independent users. Single-query requests are due on a
Poisson schedule (:func:`gpubench.gen.arrivals.poisson_due`), whether or not
earlier ones are answered, and go through an ``innr_tpu_torch``
``MicroBatcher`` (the mix's ``batcher`` settings) to the system's call. A
request's latency runs from its due time to its answer on the host;
lateness, from its due time to its submission, says how late the generator
ran. Warm-up calls every bucket size the batcher can launch, then the
batcher itself.
"""

from __future__ import annotations

import time
from concurrent.futures import wait
from contextlib import nullcontext
from functools import partial

import numpy as np

import innr_tpu_torch as itt
from gpubench.gen.arrivals import poisson_due, query_order
from gpubench.loops import DRAIN_S, Window, k1_launches


def _buckets(max_batch: int) -> list:
    """Every padded size a MicroBatcher can launch (its bucket ladder:
    powers of two to ``max_batch / 2``, then quarter steps)."""
    out, b = [], 1
    while b < max_batch // 2:
        out.append(b)
        b *= 2
    step = max(max_batch // 4, 1)
    while b < max_batch:
        out.append(b)
        b += step
    return sorted(set(out + [max_batch]))


class Loop:
    def __init__(self, system, traffic: dict, pool: np.ndarray, seed: int, seconds: float,
                 rate_per_s: float | None = None):
        self.system, self.pool = system, pool
        rate = rate_per_s if rate_per_s is not None else traffic["rate_per_s"]
        if traffic["arrivals"] != "poisson":
            raise ValueError(f"gpubench: unknown arrivals {traffic['arrivals']!r}")
        self.due = poisson_due(rate, seconds, seed, traffic["name"])
        self.qidx = query_order(len(self.due), len(pool), seed)
        self.seconds = seconds
        b = traffic["batcher"]
        self.max_batch = b["max_batch"]
        self.batcher = itt.MicroBatcher(system.call, k=system.k, max_batch=b["max_batch"],
                                        max_wait_ms=b["max_wait_ms"],
                                        pipeline_depth=b["pipeline_depth"])

    def warm(self) -> None:
        for b in _buckets(self.max_batch):
            self.system.call(self.pool[:b])
        futs = [self.batcher.submit(self.pool[i % len(self.pool)])
                for i in range(4 * self.max_batch)]
        wait(futs, timeout=DRAIN_S)

    def run(self, span=nullcontext) -> Window:
        w = Window(attempted=len(self.due))
        n = len(self.due)
        done = np.full(n, np.nan)
        sent = np.empty(n)
        futs = []
        stats = self.batcher.stats
        before = (stats.requests, stats.launches, k1_launches())
        self.system.calls.clear()
        stamp = partial(_stamp, done)
        with span():
            w.t0 = t0 = time.perf_counter()
            for i in range(n):
                lag = t0 + self.due[i] - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
                sent[i] = time.perf_counter()
                f = self.batcher.submit(self.pool[self.qidx[i]])
                f.add_done_callback(partial(stamp, i))
                futs.append(f)
            deadline = t0 + self.seconds + DRAIN_S
            wait(futs, timeout=max(0.0, deadline - time.perf_counter()))
            w.t_end = float(np.nanmax(done)) if np.isfinite(done).any() else time.perf_counter()
        due_abs = t0 + self.due
        lat = np.empty(n)
        for i, f in enumerate(futs):
            if f.done() and f.exception() is None:
                vals, ids = f.result()
                w.qidx.append(self.qidx[i])
                w.vals.append(vals)
                w.ids.append(ids)
                lat[i] = done[i] - due_abs[i]
            else:
                w.failed += 1
                lat[i] = deadline - due_abs[i]
        w.latencies_ms = lat * 1e3
        w.lateness_ms = (sent - due_abs) * 1e3
        w.counters = {"batcher_requests": stats.requests - before[0],
                      "batcher_launches": stats.launches - before[1],
                      "k1_launches": k1_launches() - before[2]}
        return w

    def close(self) -> None:
        self.batcher.close()


def _stamp(done: np.ndarray, i: int, _future) -> None:
    done[i] = time.perf_counter()
