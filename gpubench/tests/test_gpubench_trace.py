"""The roofline and idle-share arithmetic, with overlapping intervals."""

import pytest

from gpubench import roofline
from gpubench.record import Record, idle_share, k1_roofline_pct
from gpubench.system import Call
from gpubench.trace import Trace, covered, gaps, union


def test_union_merges_overlaps_and_gaps_are_the_rest():
    iv = [(10, 30), (20, 40), (60, 70), (65, 66), (40, 45)]
    assert union(iv) == [[10, 45], [60, 70]]
    assert covered(iv) == 45
    assert gaps(iv, 0, 100) == [(0, 10), (45, 60), (70, 100)]
    assert gaps([], 5, 9) == [(5, 9)]


def _event(name, cat, ts, dur, **extra):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **extra}


def _trace():
    ev = [_event("gpubench.window", "user_annotation", 0, 100, tid=1),
          _event("aten::topk", "cpu_op", 42, 10, tid=2),
          # card 0: a K1 scan and a copy that overlap, the merge, one more op
          _event("void knn_scan_tc<float, 32, false>(TcArgs)", "kernel", 10, 20,
                 args={"device": 0}),
          _event("Memcpy DtoH", "gpu_memcpy", 20, 20, args={"device": 0}),
          _event("knn_merge(long long const*)", "kernel", 60, 10, args={"device": 0}),
          _event("at::topk_kernel", "kernel", 95, 20, args={"device": 0}),  # clipped at 100
          # card 1: half the window
          _event("void knn_scan_tc<float, 32, false>(TcArgs)", "kernel", 0, 50,
                 args={"device": 1})]
    return Trace(ev)


def test_busy_is_the_union_of_overlapping_device_intervals():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s(0) == pytest.approx(45e-6)  # [10, 40) + [60, 70) + [95, 100)
    assert tr.busy_s(1) == pytest.approx(50e-6)
    assert tr.mean_busy_s(2) == pytest.approx(47.5e-6)
    assert tr.k1_s() == pytest.approx((20 + 10 + 50) * 1e-6)
    rec = Record("c", {}, {}, 2, 0.0, None, [], tr)
    assert idle_share(rec) == pytest.approx(1 - 0.475)


def test_breakdown_names_idle_gaps_by_what_the_host_did():
    # one call from 5 to 55 us on the host clock, whose window began at 2 s
    b = _trace().breakdown([Call(2.0 + 5e-6, 2.0 + 55e-6, 4)], 2.0)
    assert b["device_ops"][0][0].startswith("void knn_scan_tc")
    idle = dict(b["idle_gaps"])
    # A gap is named by what the host did at its middle: [0, 10) at 5 (the
    # call has begun, no operator yet), [40, 60) at 50 (inside aten::topk),
    # [70, 95) at 82.5 (the call has ended).
    assert idle == pytest.approx({"in call: (no traced operator)": 10e-6, "in call: aten::topk": 20e-6,
                                  "no call in flight": 25e-6})


def test_roofline_counts_match_the_worked_sizes():
    # deep-100M: the read at Q <= 32, the operations at Q = 10,000
    t, by = roofline.knn_bound_s(100_000_000, 96, 32, 10, norms=True)
    assert by == "bytes" and t == pytest.approx(11.58e-3, rel=1e-3)
    t, by = roofline.knn_bound_s(100_000_000, 96, 10_000, 10, norms=True)
    assert by == "ops" and t == pytest.approx(0.38788, rel=1e-4)
    t, _ = roofline.knn_bound_s(30_000_000, 100, 32, 10, norms=True)
    assert t == pytest.approx(3.62e-3, rel=2e-3)
    t, _ = roofline.knn_bound_s(25_000_000, 200, 32, 10)
    assert t == pytest.approx(5.97e-3, rel=1e-3)
    cfg = {"rows": 25_000_000, "dim": 200, "k": 10, "dtype": "float32", "metric": "ip"}
    assert roofline.call_bound_s(cfg, 32) == pytest.approx(5.97e-3, rel=1e-3)


def test_k1_roofline_is_the_calls_bound_over_k1_device_time():
    cfg = {"rows": 1_000_000, "dim": 100, "k": 10, "dtype": "float32", "metric": "l2"}
    calls = [Call(0.0, 1.0, 32), Call(1.0, 2.0, 7)]
    tr = _trace()
    rec = Record("c", cfg, {}, 1, 0.0, None, calls, tr)
    bound = sum(roofline.knn_bound_s(1_000_000, 100, n, 10, norms=True)[0] for n in (32, 7))
    assert k1_roofline_pct(rec) == pytest.approx(100 * bound / tr.k1_s())
    assert k1_roofline_pct(Record("c", cfg, {}, 1, 0.0, None, calls, None)) is None
