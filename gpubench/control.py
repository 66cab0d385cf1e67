"""The control of the comparison that decides ``correct``: the plain
reference in TF32 put in the program's place, at a cell's own size.

    python3 -m gpubench.control --workload <cell> --seeds 11,12,13 [--seconds 30]

For each seed it makes the cell's corpus and queries, takes the queries
whose answers a run of ``--seconds`` checks against the reference (of an
open loop's requests or a closed loop's whole pool, at most
``check_queries`` drawn from the seed), answers them with
the ``control_topk`` of its plain reference and compares those answers as a
run compares the program's (:mod:`gpubench.compare`). One JSON line a seed: the numbers, their limits
and ``fails`` (true where a number is over its limit, as it has to be).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gpubench import bench
from gpubench.compare import checked_queries, compare, verdict
from gpubench.gen.arrivals import query_order
from gpubench.run import cache_env
from gpubench.system import corpus_blocks, deleted_ids


def asked_queries(cell, seed: int, seconds: float) -> np.ndarray:
    """The pool indices whose answers a run of ``seconds`` checks."""
    pool = cell.config["queries"]
    if cell.traffic["loop"] != "open":
        asked = np.arange(pool)
    else:
        asked = query_order(max(1, int(round(cell.traffic["rate_per_s"] * seconds))), pool, seed)
    return checked_queries(asked, cell.config["check_queries"], seed)


def control(cell, seed: int, seconds: float, devices: list) -> dict:
    cfg = cell.config
    gen = bench.generator(cfg["generator"], cell.root)
    ref = bench.reference(cfg["index"], cell.root)
    blocks = corpus_blocks(cfg, seed, devices, cell.root)
    pool = gen.queries(cfg, seed, devices[0])
    asked = asked_queries(cell, seed, seconds)
    q = pool[torch.from_numpy(asked).to(pool.device)]
    t = time.perf_counter()
    truth = ref.exact_topk(blocks, q, cfg["k"], cfg["metric"])
    t_ref = time.perf_counter() - t
    vals, ids = ref.control_topk(blocks, q, cfg["k"], cfg["metric"])
    t_ctl = time.perf_counter() - t - t_ref
    numbers = compare(np.arange(len(asked)), vals.cpu().numpy(), ids.cpu().numpy(), truth,
                      blocks, q, cfg, deleted_ids(blocks), ref)
    return {"workload": cell.name, "seed": seed, "queries": len(asked), "numbers": numbers,
            "limits": cfg["limits"], "fails": not verdict(numbers, cfg["limits"]),
            "reference_s": t_ref, "control_s": t_ctl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    cache_env()
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench.control: {cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    for seed in args.seeds.split(","):
        print(json.dumps(control(cell, int(seed), args.seconds, devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
