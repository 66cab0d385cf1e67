"""Reading a ``torch.profiler`` trace of the measured window.

The trace run records the window under ``torch.profiler`` (CPU and CUDA
activities) and exports Chrome-trace JSON to ``TMPDIR``; :class:`Trace`
reads it back:

- device intervals: kernels, copies and memsets (``kernel``,
  ``gpu_memcpy``, ``gpu_memset``) a card, clipped to the window (the
  ``gpubench.window`` span);
- busy time: the *union* of a card's intervals, so operations that overlap
  on several streams count once (a sum would count them twice); idle is the
  rest of the window;
- K1's device time: the kernels named ``knn_scan_tc*`` and ``knn_merge``
  (``innr_tpu_torch/csrc/knn.cu``);
- the breakdown: the device operations that took most time, and the idle
  gaps of the first card by what the host was doing at each gap's middle:
  inside one of the window's calls (the benchmark's own host-clock
  records, placed on the trace's clock by the window's start), the
  innermost host operator then on any thread the profiler saw, else none.
"""

from __future__ import annotations

import bisect
import gzip
import json
import re
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
K1 = re.compile(r"\bknn_scan_tc\b|\bknn_merge\b")
NAME_CHARS = 96


def union(intervals) -> list:
    """Sorted, merged ``[start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, start: float, end: float) -> list:
    """The parts of ``[start, end)`` that no interval covers."""
    out, at = [], start
    for s, e in union(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """A trace's window, its device intervals by card (microseconds) and the
    host's spans and operators by thread."""

    def __init__(self, events: list):
        win = [e for e in events if e.get("name") == "gpubench.window"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("trace: no gpubench.window span")
        w = win[0]
        self.start, self.end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = defaultdict(list)  # card -> [(start, end, name)]
        ops = []  # (start, end, name), every thread
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            end = s + float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                s, end = max(s, self.start), min(end, self.end)
                if end > s:
                    card = int(e.get("args", {}).get("device", e.get("pid", 0)))
                    self.device[card].append((s, end, e.get("name", "")))
            elif cat == "cpu_op":
                ops.append((s, end, e.get("name", "")))
        self.ops = sorted(ops)
        self._op_starts = [o[0] for o in self.ops]

    @classmethod
    def load(cls, path) -> "Trace":
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self, card: int) -> float:
        return covered((s, e) for s, e, _ in self.device.get(card, ())) / 1e6

    def mean_busy_s(self, cards: int) -> float:
        return sum(self.busy_s(c) for c in range(cards)) / cards

    def k1_s(self) -> float:
        """K1's device time over every card."""
        return sum(e - s for evs in self.device.values() for s, e, n in evs
                   if K1.search(n)) / 1e6

    def _host_label(self, t: float, calls: list, starts: list, look_back: int = 256) -> str:
        """What the host did at ``t``: in a call, the innermost operator (the
        latest-starting one that covers ``t``); else no call in flight."""
        i = bisect.bisect_right(starts, t)
        if not any(t < e for _, e in calls[max(0, i - look_back):i]):
            return "no call in flight"
        j = bisect.bisect_right(self._op_starts, t)
        name = next((o[2] for o in reversed(self.ops[max(0, j - look_back):j]) if t < o[1]),
                    "(no traced operator)")
        return f"in call: {name}"[:NAME_CHARS]

    def breakdown(self, calls=(), t0: float = 0.0) -> dict:
        """``calls``: the window's (start, end, ...) host-clock records, in
        seconds, ``t0`` the window's start on the same clock."""
        on_trace = sorted(((c[0] - t0) * 1e6 + self.start, (c[1] - t0) * 1e6 + self.start)
                          for c in calls)
        starts = [s for s, _ in on_trace]
        by_op = defaultdict(float)
        for evs in self.device.values():
            for s, e, n in evs:
                by_op[n[:NAME_CHARS]] += (e - s) / 1e6
        idle = defaultdict(float)
        for s, e in gaps([(s, e) for s, e, _ in self.device.get(0, ())], self.start, self.end):
            idle[self._host_label((s + e) / 2, on_trace, starts)] += (e - s) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(idle)}
