"""The open loop's schedule, its query order, and its lateness record."""

import threading
import time

import numpy as np
import pytest

from gpubench.gen.arrivals import poisson_due, query_order
from gpubench import bench


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 9_000_000_001])
def test_every_seed_gets_the_same_gaps_in_another_order(seed):
    due = poisson_due(880.0, 10.0, seed, "mix")
    other = poisson_due(880.0, 10.0, seed + 1, "mix")
    assert len(due) == len(other) == 8800
    assert due[0] == 0.0 and (np.diff(due) > 0).all() and due[-1] < 10.0
    # the gaps, the last one up to the window's end included, are one multiset
    gaps_of = lambda d: np.sort(np.diff(np.append(d, 10.0)))  # noqa: E731
    np.testing.assert_allclose(gaps_of(due), gaps_of(other), rtol=1e-9, atol=1e-12)
    assert not np.array_equal(due, other)
    np.testing.assert_array_equal(due, poisson_due(880.0, 10.0, seed, "mix"))
    # exponential gaps: mean 1 / rate, standard deviation about the same
    gaps = np.diff(due)
    assert gaps.mean() == pytest.approx(1 / 880.0, rel=0.01)
    assert gaps.std() == pytest.approx(1 / 880.0, rel=0.1)


def test_query_order_is_a_permutation_repeated():
    idx = query_order(25, 10, 4)
    assert sorted(idx[:10]) == list(range(10))
    np.testing.assert_array_equal(idx[10:20], idx[:10])
    assert not np.array_equal(query_order(10, 10, 5), idx[:10])


def test_bucket_ladder():
    buckets = bench.module("loops", "open")._buckets
    assert buckets(32) == [1, 2, 4, 8, 16, 24, 32]
    assert buckets(1) == [1]


class _Stub:
    """A system whose call takes 2 ms and answers with the query's first
    value."""

    k = 3

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def call(self, qs, k=None):
        time.sleep(0.002)
        with self.lock:
            self.calls.append(len(qs))
        return np.repeat(qs[:, :1], 3, 1), np.tile(np.arange(3), (len(qs), 1))


def test_open_loop_records_latency_from_due_time_and_lateness():
    pool = np.arange(40, dtype=np.float32).reshape(20, 2)
    traffic = {"name": "t", "arrivals": "poisson", "rate_per_s": 300.0,
               "batcher": {"max_batch": 8, "max_wait_ms": 1.0, "pipeline_depth": 2}}
    loop = bench.loop("open")(_Stub(), traffic, pool, 1, 0.5)
    loop.warm()
    w = loop.run()
    loop.close()
    assert w.attempted == 150 and w.failed == 0 and len(w.qidx) == 150
    assert (w.lateness_ms > -1e-6).all() and (w.latencies_ms >= 2.0).all()
    # latency counts from the due time, so it covers the lateness
    assert (w.latencies_ms + 1e-6 >= w.lateness_ms).all()
    for q, vals in zip(w.qidx, w.vals):
        assert vals[0] == pool[q, 0]
    assert w.counters["batcher_requests"] == 150
    assert w.t_end >= w.t0 + 0.48
