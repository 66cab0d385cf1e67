"""The port's span log (innr_tpu_torch.utils.trace): off without a profiler,
and under one the serving, index and dispatch spans with their parents,
threads and attributes, placed on the profiler's clock.

Every wait carries a timeout, so a hang fails in seconds."""

import json
import threading
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch._C._profiler import _ExperimentalConfig  # noqa: E402

import innr_tpu_torch as tt  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.kernels import knn as tk  # noqa: E402
from innr_tpu_torch.utils import trace  # noqa: E402

WAIT = 20.0
D = 8


@pytest.fixture(autouse=True)
def _fresh_log():
    """Host data on the CPU, and an empty log for each test."""
    previous = config.set_default_device("cpu")
    trace.clear()
    yield
    trace.clear()
    config.set_default_device(previous)


def profiled(all_threads: bool = False):
    kw = ({"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
          if all_threads else {})
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw)


def chrome_events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def three_segments(rng) -> "tt.SegmentedCorpus":
    sc = tt.SegmentedCorpus(D, auto_compact=False)
    for _ in range(3):
        sc.add(rng.integers(-3, 4, (120, D)).astype(np.float32))
    sc.delete([7, 130])  # segments 0 and 1 masked, segment 2 not
    return sc


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert not trace.on()
    s = trace.span("dispatch.k1_pass", rows=4, n_q=10)
    assert s is trace.span("other") and s is trace._OFF
    with s as inner:
        inner.set(rescored=5)
    assert trace.current_id() is None
    assert trace.spans() == [] and trace.dropped() == 0


def test_off_path_allocates_nothing_per_span():
    rows, n_q = 4, 10
    for _ in range(100):  # first calls settle the interpreter's caches
        with trace.span("dispatch.k1_pass", rows=rows, n_q=n_q):
            pass
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in range(100_000):
            with trace.span("dispatch.k1_pass", rows=rows, n_q=n_q):
                pass
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 100,000 spans: a record each would hold megabytes
    assert after - before < 1024 and peak - before < 4096
    assert trace.spans() == []


def test_profiler_flag_reads_true_on_a_worker_thread():
    """The on/off rule reads a private, process-wide flag of the profiler;
    an upgrade that renames or scopes it fails here."""
    with ThreadPoolExecutor(1) as ex:
        assert ex.submit(trace.on).result(WAIT) is False
        with profiled():
            assert autograd_profiler._is_profiler_enabled is True
            assert ex.submit(trace.on).result(WAIT) is True
        assert ex.submit(trace.on).result(WAIT) is False


def _by(spans, name):
    return [s for s in spans if s.name == name]


def test_microbatcher_over_segments_records_the_span_tree(rng, tmp_path):
    sc = three_segments(rng)
    queries = rng.integers(-3, 4, (5, D)).astype(np.float32)
    main = threading.get_ident()
    with tt.MicroBatcher(sc, k=4, max_batch=8, max_wait_ms=500.0) as mb:
        with profiled() as prof:
            with trace.span("client") as client:
                t_before = time.perf_counter_ns()
                futs = [mb.submit(q) for q in queries]
                t_after = time.perf_counter_ns()
            got = [f.result(WAIT) for f in futs]
    spans = trace.spans()
    want_vals, want_ids = sc.knn_dot(queries, 4)
    for i, (vals, ids) in enumerate(got):
        np.testing.assert_array_equal(ids, want_ids[i])
        np.testing.assert_array_equal(vals, want_vals[i])

    (win,) = _by(spans, "batcher.window")
    assert win.parent == client.id  # carried from the submitting thread
    assert win.thread != main  # a flush worker
    assert win.attrs["n"] == 5 and win.attrs["bucket"] == 6  # 5 pads to 6 on max_batch 8
    stamps = win.attrs["submit_ns"]
    assert len(stamps) == 5 and stamps == sorted(stamps)
    assert t_before <= stamps[0] and stamps[-1] <= t_after <= win.start_ns

    (scan,) = _by(spans, "batcher.scan")
    (deliver,) = _by(spans, "batcher.deliver")
    (call,) = _by(spans, "index.call")
    assert scan.parent == win.id and deliver.parent == win.id and call.parent == scan.id
    assert scan.end_ns <= deliver.start_ns
    (to_device,) = _by(spans, "index.to_device")
    assert to_device.parent == call.id and call.start_ns <= to_device.start_ns
    segs = _by(spans, "index.segment")
    assert len(segs) == 3 and to_device.end_ns <= segs[0].start_ns
    passes = _by(spans, "dispatch.k1_pass")
    assert len(passes) == 3
    for seg, p in zip(segs, passes):
        assert seg.parent == call.id and p.parent == seg.id
        # the plain version has no device counter of re-scored pairs
        assert p.attrs == {"rows": 120, "n_q": 6}
    (merge,) = _by(spans, "index.merge")
    assert merge.attrs == {"segments": 3, "candidates": 3 * 4}  # one merge of k = 4 a segment
    (to_host,) = _by(spans, "index.to_host")
    assert merge.parent == call.id and to_host.parent == call.id
    assert segs[-1].end_ns <= merge.start_ns <= merge.end_ns <= to_host.start_ns
    assert to_host.end_ns <= call.end_ns <= scan.end_ns <= win.end_ns
    assert {s.thread for s in spans if s.name != "client"} == {win.thread}
    assert len({s.id for s in spans}) == len(spans)

    # The profiler records its own thread only: the worker's spans are in
    # the log, not in the Chrome trace.
    names = {e.get("name") for e in chrome_events(prof, tmp_path)}
    assert "client" in names and not names & {"batcher.window", "index.call"}


def test_profiling_all_threads_puts_worker_spans_in_the_chrome_trace(rng, tmp_path):
    sc = three_segments(rng)
    with tt.MicroBatcher(sc, k=3, max_batch=4, max_wait_ms=1.0) as mb:
        mb.search(rng.integers(-3, 4, D).astype(np.float32), timeout=WAIT)  # workers started
        with profiled(all_threads=True) as prof:
            mb.search(rng.integers(-3, 4, D).astype(np.float32), timeout=WAIT)
    names = [e.get("name") for e in chrome_events(prof, tmp_path) if e.get("ph") == "X"]
    for name in ("batcher.window", "batcher.scan", "index.call", "index.to_device",
                 "index.segment", "dispatch.k1_pass", "index.merge", "index.to_host",
                 "batcher.deliver"):
        assert names.count(name) == len(_by(trace.spans(), name)) >= 1, name


def test_batch_knn_spans_on_the_main_thread_match_the_chrome_trace(rng, tmp_path):
    vb = tt.VerticalBatch(rng.standard_normal((500, D)).astype(np.float32))
    qs = rng.standard_normal((3, D)).astype(np.float32)
    # A process's first record_function is slow to return after its stamp,
    # which would put the anchor, not the log, off the trace's clock.
    with torch.profiler.record_function("warm-up"):
        pass
    with profiled() as prof:
        with torch.profiler.record_function("gpubench.window"):
            t0 = time.perf_counter()
            tt.batch_knn(qs, vb, 5)
            tt.batch_knn_dot(qs[0], vb, 2)
    events = chrome_events(prof, tmp_path)
    (anchor,) = [e for e in events if e.get("name") == "gpubench.window"]
    spans = trace.spans()
    calls = _by(spans, "index.call")
    assert len(calls) == 2 and all(c.attrs == {} for c in calls)
    for name in ("index.call", "index.to_device", "dispatch.k1_pass", "index.to_host"):
        logged = sorted(s.start_ns for s in _by(spans, name))
        traced = sorted(float(e["ts"]) for e in events
                        if e.get("name") == name and e.get("ph") == "X")
        assert len(logged) == len(traced) == 2, name
        for t_ns, ts in zip(logged, traced):
            mapped = t_ns / 1e3 - t0 * 1e6 + float(anchor["ts"])
            assert abs(mapped - ts) < 1000.0, (name, mapped - ts)
    for c in calls:
        (d,) = [s for s in spans if s.name == "index.to_device" and s.parent == c.id]
        (p,) = [s for s in spans if s.name == "dispatch.k1_pass" and s.parent == c.id]
        (h,) = [s for s in spans if s.name == "index.to_host" and s.parent == c.id]
        assert c.start_ns <= d.start_ns <= d.end_ns <= p.start_ns <= p.end_ns <= h.start_ns
        assert h.end_ns <= c.end_ns


def test_multi_pass_k_records_one_span_a_pass(rng):
    rows = torch.from_numpy(rng.standard_normal((700, D)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32))
    k = tk.single_pass_k(2) + 44
    with profiled():
        tk.fused_knn_keys_batch(qs, rows, None, k, "dot")
    passes = _by(trace.spans(), "dispatch.k1_pass")  # k - 44 rows, then 44
    assert [p.attrs for p in passes] == [{"rows": 700, "n_q": 2}] * 2
    assert passes[0].end_ns <= passes[1].start_ns


def test_span_window_filter_and_nesting():
    with profiled():
        with trace.span("outer", a=1) as outer:
            with trace.span("inner") as inner:
                assert trace.current_id() == inner.id
            outer.set(b=2)
        with trace.span("late", parent=outer.id):
            pass
    spans = {s.name: s for s in trace.spans()}
    assert spans["outer"].attrs == {"a": 1, "b": 2} and spans["outer"].parent is None
    assert spans["inner"].parent == outer.id and spans["late"].parent == outer.id
    assert [s.name for s in trace.spans(spans["inner"].start_ns, spans["inner"].start_ns)] == [
        "inner"]
    assert trace.spans(spans["late"].start_ns + 1) == []


def test_a_full_log_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace._LOG, "capacity", 3)
    with profiled():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    spans = trace.spans()
    assert [s.name for s in spans] == ["s0", "s1", "s2"]
    assert trace.dropped() == 2
    first_dropped = spans[-1].end_ns  # s3 started after s2 ended
    assert trace.dropped(first_dropped, None) == 2
    assert trace.dropped(None, spans[0].start_ns) == 0  # no drop started that early
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


@pytest.mark.cuda
def test_k1_pass_counters_sum_to_the_per_launch_rescore_stats():
    """The ``rescored`` counters of a window's dispatch.k1_pass spans, summed
    once after it, equal the rescore_stats() readings taken one launch at a
    time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randn((200_000, 96), generator=gen, device=dev)
    norms2 = (rows * rows).sum(dim=1)
    per_launch = []
    with profiled():
        for n_q, k in ((1, 10), (7, 10), (32, 100), (64, 10)):
            qs = torch.randn((n_q, 96), generator=gen, device=dev)
            tk.fused_knn_keys_batch(qs, rows, norms2, k, "l2")
            per_launch.append(tk.rescore_stats())
    passes = _by(trace.spans(), "dispatch.k1_pass")
    assert len(passes) == len(per_launch) == 4
    counters = [p.attrs["rescored"] for p in passes]
    assert all(c.device == dev for c in counters)
    assert int(torch.cat(counters).sum()) == sum(pairs for _, _, pairs in per_launch) > 0
    assert [(p.attrs["rows"], p.attrs["n_q"]) for p in passes] == [
        (n, q) for n, q, _ in per_launch]
