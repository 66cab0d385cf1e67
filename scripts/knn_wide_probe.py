#!/usr/bin/env python3
"""K1's two schedules over f32 corpora at growing query counts, on one GPU.

    python3 scripts/knn_wide_probe.py [OUT.json] [--dims 96,100,128]
        [--ks 10,100,256] [--queries 64,128,256,1024,10000]

Builds the library, prints the compiler's report for every f32
``knn_scan_tc`` instance (registers, spills, and any warning such as a
serialised ``wgmma``), then, for each D and k (by default D = 96 and k =
10), times ``fused_knn_keys_batch`` (the scan, ``knn_merge`` and the host
work of one call; CUDA events, median of the calls) over 10M x D unit f32
rows, L2, at each query count, on each schedule in turn (tile, wide, wide,
tile: the planner's ``scan_path`` replaced by the one asked for), with the
re-scored pairs per query, each schedule's query tile (the wide one's per
warpgroup, 0 where it has no layout: then only the tile is reported) and
the planner's own choice, and checks that both schedules return the same
keys and rows. Prints one line per cell, then one JSON
object with the card's name and power limit (written to OUT.json too when
given).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from innr_tpu_torch.kernels import _build, knn  # noqa: E402

N = 10_000_000
ORDER = ("tile", "wide", "wide", "tile")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip()


def report() -> list[str]:
    """The compiler's lines for each f32 knn_scan_tc instance and every warning."""
    lines, keep = [], False
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            keep = "knn_scan_tc" in line
        if (keep and "IfLi" in line) or "warning" in line.lower():
            lines.append(re.sub(r"\s+", " ", line.strip()))
    return lines


def unit(t):
    return t / torch.linalg.vector_norm(t, dim=1, keepdim=True)


def time_call(qs, rows, norms2, k: int, reps: int, path: str):
    """Median ms of a call on schedule ``path`` over reps calls after one
    warm-up; re-scored pairs of the last; the warm-up's (keys, rows)."""
    knn.scan_path = lambda *args: path
    before = knn.LAUNCHES_BY_PATH[path]
    out = knn.fused_knn_keys_batch(qs, rows, norms2, k, "l2")
    torch.cuda.synchronize()
    assert knn.LAUNCHES_BY_PATH[path] == before + 1
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        knn.fused_knn_keys_batch(qs, rows, norms2, k, "l2")
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], knn.rescore_stats()[2], out


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?")
    ap.add_argument("--dims", type=ints, default=[96])
    ap.add_argument("--ks", type=ints, default=[10])
    ap.add_argument("--queries", type=ints, default=[64, 128, 256, 1024, 10_000])
    args = ap.parse_args()
    planner = knn.scan_path
    t0 = time.time()
    _build.load()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for line in report():
        print(line)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20)
    results = []
    for d in args.dims:
        rows = unit(torch.randn(N, d, generator=gen, device=dev))
        norms2 = (rows * rows).sum(dim=1)
        for k in args.ks:
            for n_q in args.queries:
                qs = unit(torch.randn(n_q, d, generator=gen, device=dev))
                tiles = {path: knn._grid(rows, n_q, k, path)[0] for path in ("tile", "wide")}
                cell = {"d": d, "k": k, "n_q": n_q, "tile_q": tiles["tile"],
                        "wide_wg_q": tiles["wide"] // 2, "planner": planner(rows, n_q, k)}
                if not tiles["wide"]:  # the library has no wide layout here
                    print(json.dumps(cell), flush=True)
                    results.append(cell)
                    continue
                outs = {}
                for turn, path in enumerate(ORDER):
                    ms, pairs, outs[path] = time_call(qs, rows, norms2, k,
                                                      3 if n_q >= 1024 else 7, path)
                    rec = {**cell, "path": path, "turn": turn, "ms": ms,
                           "us_per_query": 1e3 * ms / n_q, "rescored_per_query": pairs / n_q}
                    print(json.dumps(rec), flush=True)
                    results.append(rec)
                knn.scan_path = planner
                same = all(torch.equal(a, b) for a, b in zip(outs["tile"], outs["wide"]))
                print(json.dumps({**cell, "same_keys_and_rows": same}), flush=True)
                results.append({**cell, "same_keys_and_rows": same})
        del rows, norms2
        torch.cuda.empty_cache()
    out = {"card": card(), "n": N, "cells": results}
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
