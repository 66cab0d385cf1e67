"""The readers of the port's span log (``gpubench/metrics/_spans.py`` and the
five metrics on it), on a synthetic record and span log: their arithmetic,
the window filter, and nothing reported where the program has no span log,
the window holds no span or the log dropped spans in it."""

import sys

import pytest
import torch

from gpubench import bench
from gpubench.loops import Window
from gpubench.record import Record
from gpubench.trace import Trace
from innr_tpu_torch.utils import trace as log

READERS = ["serving.queue_wait_ms.serve", "serving.pad_share.serve",
           "index.host_issue_ms.serve", "device.idle_host_share.serve",
           "kernel.k1_rescored_share.batch"]
T0 = 100.0  # the window's start, perf_counter seconds
T0_NS = int(T0 * 1e9)
US, MS = 1_000, 1_000_000


def at(ns: int) -> int:
    return T0_NS + ns


def _trace() -> Trace:
    """A 100 us window starting at 1000 us on the trace's clock; card 0 busy
    in [1010, 1030) and [1060, 1070)."""
    ev = [{"ph": "X", "name": "gpubench.window", "cat": "user_annotation", "ts": 1000,
           "dur": 100},
          {"ph": "X", "name": "knn_scan_tc", "cat": "kernel", "ts": 1010, "dur": 20,
           "args": {"device": 0}},
          {"ph": "X", "name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 1060, "dur": 10,
           "args": {"device": 0}}]
    return Trace(ev)


# (id, parent, name, thread, start, end, attrs): one record a span
SPANS = [
    # before the window: left out by every reader
    (90, None, "batcher.window", 2, at(-5 * MS), at(-1 * MS),
     {"n": 1, "bucket": 32, "submit_ns": [at(-6 * MS)]}),
    (91, 90, "batcher.scan", 2, at(-4 * MS), at(-2 * MS), {}),
    (92, None, "index.call", 2, at(-4 * MS), at(-2 * MS), {}),
    (93, 92, "index.to_host", 2, at(-3 * MS), at(-2 * MS), {}),
    (94, None, "dispatch.k1_pass", 1, at(-4 * MS), at(-3 * MS),
     {"rows": 10, "n_q": 1, "rescored": torch.tensor([10])}),
    # window A: two requests waited 4 and 3 ms for the scan; 5 of 6 rows real
    (1, None, "batcher.window", 2, at(4 * MS), at(9 * MS),
     {"n": 5, "bucket": 6, "submit_ns": [at(1 * MS), at(2 * MS)]}),
    (2, 1, "batcher.scan", 2, at(5 * MS), at(8 * MS), {}),
    (3, 2, "index.call", 2, at(5 * US), at(28 * US), {}),
    (4, 3, "index.to_host", 2, at(20 * US), at(25 * US), {}),
    (14, 3, "index.to_device", 2, at(5 * US), at(9 * US), {}),  # not issue time
    # window B: one request waited 2 ms, one came before tracing (stamp 0)
    (5, None, "batcher.window", 3, at(10 * MS), at(15 * MS),
     {"n": 8, "bucket": 8, "submit_ns": [at(10 * MS), 0]}),
    (6, 5, "batcher.scan", 3, at(12 * MS), at(14 * MS), {}),
    (7, 6, "index.call", 3, at(40 * US), at(55 * US), {}),
    (8, 7, "index.to_host", 3, at(50 * US), at(55 * US), {}),
    (9, None, "batcher.window", 3, at(16 * MS), at(17 * MS),
     {"n": 1, "bucket": 1, "submit_ns": []}),
    # a call that never reached its copy (no index.to_host): no issue time
    (10, None, "index.call", 3, at(80 * US), at(85 * US), {}),
    # K1 passes: two with device counters, one plain
    (11, 3, "dispatch.k1_pass", 2, at(10 * US), at(19 * US),
     {"rows": 1000, "n_q": 4, "rescored": torch.tensor([100])}),
    (12, 7, "dispatch.k1_pass", 3, at(41 * US), at(49 * US),
     {"rows": 500, "n_q": 2, "rescored": torch.tensor([50])}),
    (13, None, "dispatch.k1_pass", 1, at(60 * US), at(61 * US),
     {"rows": 7, "n_q": 7}),
]


@pytest.fixture
def record():
    """The synthetic log loaded into the port's span log (emptied after)."""
    log.clear()
    log._LOG.records.extend(SPANS)
    yield Record("c", {}, {}, 1, 0.0, Window(t0=T0, t_end=T0 + 0.1), [], _trace())
    log.clear()


def read(name, rec):
    return bench.reader(name)(rec)


def test_queue_wait_is_the_median_submit_to_scan(record):
    # waits 4, 3 (window A) and 2 ms (window B; its unstamped request left out)
    assert read("serving.queue_wait_ms.serve", record) == pytest.approx(3.0)


def test_pad_share_is_pad_rows_over_launched_rows(record):
    assert read("serving.pad_share.serve", record) == pytest.approx(1 / 15)


def test_host_issue_is_the_median_call_start_to_its_copy(record):
    # 15 us less 4 in the queries' copy (call 3) and 10 us (call 7); call
    # 10 has no copy
    assert read("index.host_issue_ms.serve", record) == pytest.approx(10.5e-3)


def test_idle_host_share_and_the_idle_split(record):
    from gpubench.metrics._spans import idle_split, window_spans

    # on the trace: call 3 issues in [1005, 1020), copies in [1020, 1025);
    # call 7 issues in [1040, 1050), copies in [1050, 1055); call 10 issues
    # in [1080, 1085); card 0 idle outside [1010, 1030) and [1060, 1070)
    split = idle_split(record, window_spans(record))
    assert split == pytest.approx({"host issuing": 20e-6, "waiting in index.to_host": 5e-6,
                                   "in call, after its copy": 0.0,
                                   "no call in flight": 45e-6})
    assert sum(split.values()) == pytest.approx(70e-6)  # the idle time
    assert read("device.idle_host_share.serve", record) == pytest.approx(0.2)


def test_k1_rescored_share_sums_the_pass_counters(record):
    assert read("kernel.k1_rescored_share.batch", record) == pytest.approx(150 / 5000)


def test_idle_host_share_needs_a_device_trace(record):
    cpu_only = Record("c", {}, {}, 1, 0.0, record.window, [], Trace(
        [{"ph": "X", "name": "gpubench.window", "cat": "user_annotation", "ts": 0, "dur": 9}]))
    assert read("device.idle_host_share.serve", cpu_only) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_the_span_log(name, record, monkeypatch):
    assert read(name, record) is not None
    monkeypatch.setitem(sys.modules, "innr_tpu_torch.utils.trace", None)  # a program without it
    assert read(name, record) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_an_empty_window(name, record):
    log.clear()
    assert read(name, record) is None
    log._LOG.records.extend(s for s in SPANS if s[4] < T0_NS)  # spans before the window only
    assert read(name, record) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_where_spans_were_dropped_in_the_window(name, record, monkeypatch):
    monkeypatch.setattr(log._LOG, "dropped", 4)
    monkeypatch.setattr(log._LOG, "dropped_starts", (at(-9 * MS), at(-8 * MS)))
    assert read(name, record) is not None  # dropped before the window
    monkeypatch.setattr(log._LOG, "dropped_starts", (at(-9 * MS), at(3 * MS)))
    assert read(name, record) is None
