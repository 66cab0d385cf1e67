#!/usr/bin/env python3
"""One traced run of a benchmark cell, read through the port's span log.

    python3 scripts/span_report.py --workload <cell> --seed <n> --seconds <s> [OUT.json]

Runs the cell as ``python3 -m gpubench.run ... --trace 1`` does (the same
set-up, window, profiler and readers, in this process) and adds what the
result line does not carry:

- the card's idle time in the window by what the host did meanwhile
  (``gpubench/metrics/_spans.py:idle_split``): no call in flight, a call
  issuing its device work, a call waiting in its device-to-host copy, a
  call after its copy; in seconds and as shares of the window;
- the offset between each span of the log and its range in the profiler's
  trace, the log's start placed on the trace's clock by the window's start,
  for every span name the trace holds as often as the log (the spans of the
  profiled thread: in a closed loop the main thread makes the calls). The
  process enters one ``record_function`` before the run: with some torch
  builds a process's first is slow to return after its stamp (about a
  millisecond), which would put the window's start, and every span placed
  by it, off the trace's clock. ``gpubench.run`` has no such warm-up; where
  the first is slow, its traced runs place the spans that much early;
- per span name in the window: the count, the median duration and the
  median self time (the duration less its children's), in ms; and the
  dropped count;
- the share of the window's K1 passes (``dispatch.k1_pass``) on each of
  the scan's schedules (its ``path``: ``"wide"`` or ``"tile"``);
- the window's segment merges (``index.merge`` of a ``SegmentedCorpus``)
  by their ``segments`` and ``candidates`` attributes: how many calls
  merged that many segments' candidates, once each.

Prints the result line's metrics and these as one JSON object, also
written to ``OUT.json`` when given. Needs a CUDA card, as the benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench import bench  # noqa: E402
from gpubench import run as bench_run  # noqa: E402
from gpubench.record import Record  # noqa: E402
from gpubench.trace import Trace  # noqa: E402


def _capture() -> dict:
    """Keeps the run's record and the raw trace events as it makes them."""
    got = {}

    def record(*args):
        got["record"] = Record(*args)
        return got["record"]

    base_load = Trace.load.__func__

    def load(cls, path):
        with open(path) as f:
            got["events"] = json.load(f)["traceEvents"]
        return base_load(cls, path)

    bench_run.Record = record
    bench_run.Trace.load = classmethod(load)
    return got


def offsets_us(rec, spans, events) -> dict:
    """Per span name: the log's start on the trace's clock minus its range's
    start in the trace (us), paired in order of start; names whose counts
    differ are left out."""
    t0_us = rec.window.t0 * 1e6
    traced = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and "name" in e:
            traced[e["name"]].append(float(e["ts"]))
    logged = defaultdict(list)
    for s in spans:
        logged[s.name].append(s.start_ns / 1e3 - t0_us + rec.trace.start)
    out = {}
    for name, starts in sorted(logged.items()):
        copies = sorted(traced.get(name, ()))
        if len(copies) != len(starts):
            continue
        d = np.asarray(sorted(starts)) - np.asarray(copies)
        out[name] = {"n": len(d), "median": float(np.median(d)), "min": float(d.min()),
                     "max": float(d.max()), "max_abs": float(np.abs(d).max())}
    return out


def durations_ms(spans) -> dict:
    """Per span name: count, median duration and median self time (ms)."""
    inner = defaultdict(int)
    for s in spans:
        inner[s.parent] += s.end_ns - s.start_ns
    by_name = defaultdict(list)
    for s in spans:
        by_name[s.name].append((s.end_ns - s.start_ns, s.end_ns - s.start_ns - inner[s.id]))
    return {name: {"n": len(v), "median": float(np.median([d for d, _ in v])) / 1e6,
                   "self_median": float(np.median([x for _, x in v])) / 1e6}
            for name, v in sorted(by_name.items())}


def path_shares(spans) -> dict:
    """Share of the dispatch.k1_pass spans on each schedule (``path``)."""
    paths = [s.attrs.get("path") for s in spans if s.name == "dispatch.k1_pass"]
    return {p: paths.count(p) / len(paths) for p in sorted(set(paths), key=str)}


def merge_shapes(spans) -> dict:
    """Count of the ``index.merge`` spans by ``"<segments> x <candidates>"``."""
    shapes = defaultdict(int)
    for s in spans:
        if s.name == "index.merge":
            shapes[f"{s.attrs['segments']} x {s.attrs['candidates']}"] += 1
    return dict(sorted(shapes.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/span_report.py",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("out", nargs="?")
    args = ap.parse_args(argv)
    bench_run.cache_env()
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"span_report: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    got = _capture()
    with torch.profiler.record_function("span_report.warm-up"):
        pass
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    res = bench_run.run(cell, args.seed, args.seconds, True, devices)["result"]
    from innr_tpu_torch.utils import trace as log

    spans_mod = bench.module("metrics", "_spans")
    rec = got["record"]
    spans = spans_mod.window_spans(rec) or []
    split = spans_mod.idle_split(rec, spans) or {}
    window_s = rec.trace.window_s
    report = {
        "workload": cell.name, "seed": args.seed, "correct": res["correct"],
        "device": res["device"], "cards": bench_run._power(),
        "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "idle_s": split, "idle_share": {k: v / window_s for k, v in split.items()},
        "offset_us": offsets_us(rec, spans, got["events"]),
        "spans_ms": durations_ms(spans), "k1_paths": path_shares(spans),
        "merges": merge_shapes(spans),
        "dropped": log.dropped(),
    }
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
