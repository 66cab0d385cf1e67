"""What the span readers share: the port's span log
(``innr_tpu_torch/utils/trace.py``) over the measured window, and its spans
placed on the device trace's clock.

The log stamps spans on ``time.perf_counter_ns()``, the clock of the
window's ``t0``; the trace's ``gpubench.window`` span starts at ``t0``, so a
span at ``t`` lies ``t - t0`` after the trace's window start (as
``Trace.breakdown`` places the calls). :func:`window_spans` is None where
the program has no span log (one older than it), where the window holds no
span, or where the log dropped spans during the window: a reader then
reports nothing.
"""

from __future__ import annotations

import importlib

from gpubench.trace import covered, gaps, union


def window_spans(rec):
    """The spans that started inside the window, or None (see above)."""
    try:
        log = importlib.import_module("innr_tpu_torch.utils.trace")
    except ImportError:
        return None
    t0, t1 = int(rec.window.t0 * 1e9), int(rec.window.t_end * 1e9)
    if log.dropped(t0, t1):
        return None
    return log.spans(t0, t1) or None


def children(spans, name: str) -> dict:
    """The start of the first child named ``name`` of each span, by id."""
    out = {}
    for s in spans:
        if s.name == name and (s.parent not in out or s.start_ns < out[s.parent]):
            out[s.parent] = s.start_ns
    return out


def issue_phases(spans) -> list:
    """``(start, issued, end)`` of each ``index.call`` in ns: ``issued`` is
    the start of its ``index.to_host``, or its end where it has none."""
    to_host = children(spans, "index.to_host")
    return [(c.start_ns, to_host.get(c.id, c.end_ns), c.end_ns)
            for c in spans if c.name == "index.call"]


def on_trace(rec, intervals_ns) -> list:
    """Host-clock ``(start, end)`` ns intervals on the trace's clock (us),
    merged."""
    t0_us = rec.window.t0 * 1e6
    start = rec.trace.start
    return union([(s / 1e3 - t0_us + start, e / 1e3 - t0_us + start) for s, e in intervals_ns])


def intersect(a: list, b: list) -> list:
    """The intersection of two sorted, merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_split(rec, spans):
    """Card 0's idle time in the traced window (no kernel, copy or memset),
    in seconds, by what the host did meanwhile: ``host issuing`` (some
    thread inside an ``index.call`` before its ``index.to_host``),
    ``waiting in index.to_host`` (else some thread in a device-to-host copy
    that ends a call), ``in call, after its copy`` (else inside a call),
    ``no call in flight`` (the rest). None without a device trace."""
    tr = rec.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    idle = gaps([(s, e) for s, e, _ in tr.device.get(0, ())], tr.start, tr.end)
    phases = issue_phases(spans)
    issuing = on_trace(rec, [(s, m) for s, m, _ in phases])
    copying = on_trace(rec, [(s.start_ns, s.end_ns) for s in spans
                             if s.name == "index.to_host"])
    calls = on_trace(rec, [(s, e) for s, _, e in phases])
    busy_host = union(issuing + copying)
    anything = union(busy_host + calls)
    seen = [covered(intersect(idle, x)) / 1e6 for x in (issuing, busy_host, anything)]
    return {"host issuing": seen[0], "waiting in index.to_host": seen[1] - seen[0],
            "in call, after its copy": seen[2] - seen[1],
            "no call in flight": covered(idle) / 1e6 - seen[2]}
