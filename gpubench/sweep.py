"""The knee sweep of an open-loop cell: its latency and completed rate at
several offered rates, in one process (set-up once).

    python3 -m gpubench.sweep --workload <cell> --seed <n> --seconds <s> \\
        --rates 800,1000,1200,...

One JSON line a rate: the offered and completed rates, latency percentiles,
the MicroBatcher's mean batch, the generator's lateness, and ``growth``,
the median latency of the last fifth of the requests over the first fifth
(a backlog that grows through the window reads well above 1). The knee is
the highest rate whose completed rate keeps up with the offered one without
a growing backlog; a cell's ``rate_per_s`` is about four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gpubench import bench
from gpubench.run import cache_env
from gpubench.system import System


def sweep(cell, seed: int, seconds: float, rates: list, devices: list) -> list:
    system = System(cell.config, seed, devices, cell.root)
    pool = system.gen.queries(cell.config, seed, devices[0]).cpu().numpy()
    open_loop = bench.loop("open", cell.root)
    out = []
    for rate in rates:
        loop = open_loop(system, cell.traffic, pool, seed, seconds, rate_per_s=rate)
        loop.warm()
        w = loop.run()
        loop.close()
        lat = w.latencies_ms
        fifth = max(1, len(lat) // 5)
        c = w.counters
        row = {"rate_per_s": rate, "requests": w.attempted, "failed": w.failed,
               "completed_per_s": (w.attempted - w.failed) / (w.t_end - w.t0),
               "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
               "p99_ms": float(np.percentile(lat, 99)),
               "mean_batch": c["batcher_requests"] / max(1, c["batcher_launches"]),
               "lateness_p95_ms": float(np.percentile(w.lateness_ms, 95)),
               "growth": float(np.median(lat[-fifth:]) / np.median(lat[:fifth]))}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True, help="comma-separated offered rates, per second")
    args = ap.parse_args(argv)
    cache_env()
    cell = bench.load_cell(args.workload)
    if cell.traffic["loop"] != "open":
        print(f"gpubench.sweep: {cell.name} is not an open loop", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench.sweep: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    sweep(cell, args.seed, args.seconds, [float(r) for r in args.rates.split(",")], devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
