"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's corpus and query pool on the card from ``--seed``,
builds the container, and warms up every shape the traffic uses. The window
then runs the cell's loop for ``--seconds`` seconds; with ``--trace 1``
under ``torch.profiler``. Once it has closed (every answer in, the memory
peak read, the program's state freed) the plain reference checks every
answer. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, ``breakdown`` (traced
runs) and last ``checks``, each number compared beside its limit; the
same numbers are the last lines of standard error.

Exits 2 without a result when no CUDA card, or fewer than the cell asks
for, is visible; 3 when ``jax``, ``jaxlib``, ``flax`` or ``innr_tpu`` (the
JAX package) is loaded once the window has closed. Build caches stay in
``build/`` inside the checkout (the port builds its kernels into
``build/innr_tpu_torch``); the trace goes to ``TMPDIR`` and is deleted.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench import bench  # noqa: E402
from gpubench.compare import checked_queries, compare, verdict  # noqa: E402
from gpubench.record import Record  # noqa: E402
from gpubench.system import System, corpus_blocks, deleted_ids  # noqa: E402
from gpubench.trace import Trace  # noqa: E402

CHECKOUT = bench.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "innr_tpu"}


def cache_env() -> None:
    """Fixed cache directories inside the checkout."""
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``innr_tpu_torch`` is not ``innr_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _traced(devices):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def truth(ref, blocks, pool_dev, checked: np.ndarray, cfg: dict):
    """The reference's (ids, values, scale) for the ``checked`` pool
    queries, in (P, ...) arrays on the pool's device (NaN scale elsewhere)."""
    asked = torch.from_numpy(checked).to(pool_dev.device)
    ids, vals, scale = ref.exact_topk(blocks, pool_dev[asked], cfg["k"], cfg["metric"])
    p, k = pool_dev.shape[0], cfg["k"]
    full = (torch.full((p, k), -1, dtype=torch.int64, device=pool_dev.device),
            torch.full((p, k), torch.nan, dtype=torch.float64, device=pool_dev.device),
            torch.full((p,), torch.nan, dtype=torch.float64, device=pool_dev.device))
    for dst, src in zip(full, (ids, vals, scale)):
        dst[asked] = src
    return full


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, devices: list) -> dict:
    """One run of ``cell`` on ``devices``: ``{"result": ..., "checks": ...,
    "notes": [...]}`` (``result`` lacks ``checks``)."""
    cfg, traffic = cell.config, cell.traffic
    t_build = time.perf_counter()
    system = System(cfg, seed, devices, cell.root)
    pool_dev = system.gen.queries(cfg, seed, devices[0])
    pool = pool_dev.cpu().numpy()
    loop = bench.loop(traffic["loop"], cell.root)(system, traffic, pool, seed, seconds)
    _sync(devices)
    t_warm = time.perf_counter()
    loop.warm()
    _sync(devices)
    setup_s = time.perf_counter() - T_START
    setup_note = (f"set-up {setup_s:.3f} s: start and imports {t_build - T_START:.3f}, corpus, "
                  f"container and queries {t_warm - t_build:.3f}, warm-up "
                  f"{T_START + setup_s - t_warm:.3f}")
    # Set-up's objects are never garbage: collections in the window skip them.
    gc.collect()
    gc.freeze()
    prof = _traced(devices) if trace else None
    span = (lambda: torch.profiler.record_function("gpubench.window")) if trace else nullcontext
    if prof is not None:
        prof.__enter__()
    win = loop.run(span)
    _sync(devices)
    gc.unfreeze()
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            tr = Trace.load(path)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"),
               default=0)
    loop.close()
    rec = Record(cell.name, cfg, traffic, len(devices), setup_s, win, list(system.calls), tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = bench.reader(m["name"], cell.root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    system.free()
    t_ref = time.perf_counter()
    blocks = corpus_blocks(cfg, seed, devices, cell.root)
    ref = bench.reference(cfg["index"], cell.root)
    if win.qidx:
        qidx = np.asarray(win.qidx)
        checked = checked_queries(qidx, cfg["check_queries"], seed)
        numbers = compare(qidx, np.stack(win.vals), np.stack(win.ids),
                          truth(ref, blocks, pool_dev, checked, cfg), blocks, pool_dev, cfg,
                          deleted_ids(blocks), ref)
    else:
        numbers = {name: None for name in cfg["limits"]}
    _sync(devices)
    notes = [setup_note, f"answers: {len(win.qidx)}, their ids checked; the values of those to "
             f"{min(len(set(win.qidx)), cfg['check_queries'])} queries checked; reference and "
             f"comparison {time.perf_counter() - t_ref:.3f} s"]
    if win.lateness_ms is not None:
        notes.append(f"lateness p50 / p95 / max: {np.percentile(win.lateness_ms, 50):.4f} / "
                     f"{np.percentile(win.lateness_ms, 95):.4f} / {win.lateness_ms.max():.4f} ms")
    correct = win.failed == 0 and win.attempted > 0 and verdict(numbers, cfg["limits"])
    device = {"platform": "gpu" if devices[0].type == "cuda" else devices[0].type,
              "kind": (torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda"
                       else "cpu"),
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr.mean_busy_s(len(devices))
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown(rec.calls, win.t0)
    checks = {name: {"value": v, "limit": cfg["limits"][name]} for name, v in numbers.items()}
    return {"result": result, "checks": checks, "notes": notes}


def _power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e!r}"
    return "; ".join(out.stdout.strip().splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA card(s), {n} visible",
              file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    out = run(cell, args.seed, args.seconds, bool(args.trace), devices)
    found = forbidden_modules()
    if found:
        print(f"gpubench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"gpubench: {cell.name} seed {args.seed}: cards {_power()}", file=sys.stderr)
    for note in out["notes"]:
        print(f"gpubench: {note}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**out["result"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
