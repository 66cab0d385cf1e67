#!/usr/bin/env python3
"""Where the threshold search's time goes on one GPU: the plan, the scan
with and without its +inf fill, the compacting scan, the calls around them.

    python3 scripts/threshold_probe.py [--parent ROOT] [OUT.json]

Compiles variant builds of ``innr_tpu_torch/csrc/pruned.cu`` with nvcc
(sm_90a), each a library of its own:

- ``full``: the kernels as the package builds them;
- ``nofill`` (``-DINNR_THRESHOLD_FILL=0``): the dense kernel without its
  +inf stores over the dead tiles' rows;
- ``parent`` (with ``--parent ROOT``): ``ROOT/innr_tpu_torch/csrc/
  pruned.cu``, the earlier design (chunks of 256 rows dealt in turn to 8
  CTAs an SM, the output filled with +inf by a separate ``torch.full``),
  e.g. a ``git archive`` of the parent commit unpacked under ``build/``.

On ``chip_smoke.py``'s clustered cell (10M x 128 f32 rows near 256
centres, cluster-ordered; the query near centre 0; threshold 1.0; 96 of
2112 tiles live) it times, by CUDA events (median of 7):

- each step of ``prune.plan_threshold_survivors``, the whole plan, the
  plan's kernel call (``kernels.pruned_knn.threshold_plan``), and
  ``(q * q).sum()``;
- the dense scan alone (the library call on an allocated output), per
  build; the parent's with and without the ``torch.full`` before it; this
  build's at other grid sizes; ``threshold_dists`` (the call);
- the compacting scan alone (its memset and launch, no synchronisation) at
  several grid sizes, then with the synchronisation that reads M, then
  with the M rows and distances copied by torch to pageable or to pinned
  host memory, and ``threshold_survivors`` (the call, whose copies go
  through the library);
- ``batch_l2_squared_pruning`` end to end (CUDA events around the call,
  the host copies included), and the path it replaced, on this tree's
  dense kernel (the plain plan, the dense call, + qq, the keep-mask,
  ``nonzero``, two host copies);
- over every tile: the dense scan, the compacting call, ``torch.addmv``;
- same-bytes reads (``torch.sum``) of the surviving rows and of all rows;
- a ``torch.profiler`` trace of ten calls of ``batch_l2_squared_pruning``
  and of the dense path: device time by kernel, operators and launches a
  call, and the device's busy share of the call.

It prints one line per cell, then one JSON object with the card's name and
power limit (written to OUT.json too when given).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {"full": [], "nofill": ["-DINNR_THRESHOLD_FILL=0"]}
GRIDS = (132, 264, 528, 1056, 2112)


def build(out: Path, parent: Path | None) -> dict:
    """The variant libraries, compiled in parallel, with their C entry
    points declared."""
    import ctypes

    from innr_tpu_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    sources = {name: (_build.SRC_DIR / "pruned.cu", flags) for name, flags in VARIANTS.items()}
    if parent is not None:
        sources["parent"] = (parent / "innr_tpu_torch" / "csrc" / "pruned.cu", [])
    procs = {}
    for name, (src, flags) in sources.items():
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *flags, "-shared", "-o", str(out / f"pruned_{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"threshold_probe: nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[threshold_probe] ptxas {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(out / f"pruned_{name}.so"))
        if name == "parent":  # (..., n, d, tile_rows, chunk_rows, n_ctas, stream)
            lib.innr_threshold_scan.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr, i64, i32, i64,
                                                i64, i32, ptr]
        else:  # (..., n, d, tile_rows, n_tiles, n_ctas, stream)
            lib.innr_threshold_scan.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr, i64, i32, i64,
                                                i32, i32, ptr]
            lib.innr_threshold_compact.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr, f32, ptr,
                                                   i64, i32, i64, i32, i32, ptr]
            lib.innr_threshold_compact.restype = i32
            lib.innr_threshold_header_words.argtypes = [i64, i32]
            lib.innr_threshold_header_words.restype = i64
        lib.innr_threshold_scan.restype = i32
        libs[name] = lib
    return libs


def plan_steps(q, cent, rad, threshold: float, ms) -> dict:
    """``prune.plan_threshold_survivors``'s steps, each timed on the
    outputs of the steps before it."""
    import numpy as np
    import torch

    from innr_tpu_torch import config
    from innr_tpu_torch.prune import _pad_tail

    qs = q[None, :]
    n_tiles = cent.shape[0]
    t = {}
    qd = qs @ cent.T
    t["q @ cent.T"] = ms(lambda: qs @ cent.T)
    qq = (qs * qs).sum(dim=1, keepdim=True)
    cc = (cent * cent).sum(dim=1)[None, :]
    t["qq, cc"] = ms(lambda: ((qs * qs).sum(dim=1, keepdim=True), (cent * cent).sum(dim=1)))
    qc = torch.sqrt((qq + cc - 2.0 * qd).clamp_min(0.0))
    t["||q - c||"] = ms(lambda: torch.sqrt((qq + cc - 2.0 * qd).clamp_min(0.0)))
    lower = (qc - rad[None, :]).clamp_min(0.0)
    t["lower bound"] = ms(lambda: (qc - rad[None, :]).clamp_min(0.0))
    slack = config.PRUNE_BOUND_EPS * (qq + cc + 2.0 * qd.abs())
    t["slack"] = ms(lambda: config.PRUNE_BOUND_EPS * (qq + cc + 2.0 * qd.abs()))
    thr = float(np.float32(threshold))
    alive = ~(lower * lower > thr + slack).all(dim=0)
    t["dead, alive"] = ms(lambda: ~(lower * lower > thr + slack).all(dim=0))
    n_surv = alive.sum().to(torch.int32)
    t["n_surv"] = ms(lambda: alive.sum().to(torch.int32))
    order = torch.sort((~alive).to(torch.uint8), stable=True).indices.to(torch.int32)
    t["sort"] = ms(lambda: torch.sort((~alive).to(torch.uint8), stable=True).indices
                   .to(torch.int32))
    t["pad tail"] = ms(lambda: _pad_tail(order, n_surv, n_tiles))
    return t


def profile(fn, call_ms: float, calls: int = 10) -> dict:
    """``torch.profiler`` over ``calls`` calls: the device time by kernel,
    the host-side operators and their count per call, and the device's
    busy share of the call (device time / the call's CUDA-event time)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = {e.key: e.self_device_time_total / calls / 1e3 for e in events
              if e.self_device_time_total > 0 and not e.key.startswith("aten::")}
    aten = sum(e.count for e in events if e.key.startswith("aten::")) / calls
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                        "cudaMemsetAsync",
                                                        "cudaMemcpyAsync")) / calls
    busy = sum(device.values())
    print(f"[threshold_probe] profile: device {busy!r} ms a call of {call_ms!r} ms (busy share "
          f"{busy / call_ms!r}); {aten!r} aten operators, {launches!r} launches and copies a "
          f"call", flush=True)
    for key, t in sorted(device.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[threshold_probe]   {t!r} ms  {key[:90]}", flush=True)
    return {"device_ms": busy, "busy_share": busy / call_ms, "aten_ops": aten,
            "launches_and_copies": launches, "by_kernel_ms": device}


def main() -> int:
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import pruned_knn as tpk
    from innr_tpu_torch.prune import plan_threshold_survivors

    if not torch.cuda.is_available():
        raise SystemExit("threshold_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build(ROOT / "build" / "threshold_probe", parent)
    gpu = cs.gpu_name_and_power()
    ms = cs._median_ms
    res = {"gpu": gpu, "ms": {}}

    def note(key: str, value: float, extra: str = "") -> None:
        res["ms"][key] = value
        print(f"[threshold_probe] {key}: {value!r} ms{extra}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    n, thr = cs.N_PRUNE, 1.0
    rows, centers = cs._clustered(gen, n, 256, True, dev)
    q0 = (centers[:32] + 0.01 * torch.randn((32, 128), generator=gen, device=dev))[0].contiguous()
    vb = itt.VerticalBatch(rows)
    s, norms2 = vb.tile_summary(), vb.norms2()
    order, n_surv, _ = plan_threshold_survivors(q0[None], s.centroids, s.radii, thr)
    live = int(n_surv)
    surv_rows = min(n, live * s.tile_n)
    every = torch.arange(s.n_tiles, dtype=torch.int32, device=dev)
    all_n = torch.full((1,), s.n_tiles, dtype=torch.int32, device=dev)
    qq = (q0 * q0).sum()
    print(f"[threshold_probe] clustered {n} x 128 f32, threshold {thr}: {live} of {s.n_tiles} "
          f"tiles of {s.tile_n} rows ({surv_rows} rows); {gpu}", flush=True)
    res.update(live_tiles=live, n_tiles=s.n_tiles, tile_n=s.tile_n, surviving_rows=surv_rows)

    note("read surviving rows", ms(lambda: rows[:surv_rows].sum()))
    note("read all rows", ms(lambda: rows.sum()))
    for step, t in plan_steps(q0, s.centroids, s.radii, thr, ms).items():
        note(f"plan: {step}", t)
    note("plan: plan_threshold_survivors", ms(lambda: plan_threshold_survivors(
        q0[None], s.centroids, s.radii, thr)))
    note("plan: threshold_plan (product, sums, one plan launch)", ms(lambda: tpk.threshold_plan(
        q0[None], s.centroids, s.radii, thr)))
    note("(q * q).sum()", ms(lambda: (q0 * q0).sum()))

    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(n, dtype=torch.float32, device=dev)

    def dense(lib, order_, n_surv_, grid=0):
        rc = lib.innr_threshold_scan(q0.data_ptr(), rows.data_ptr(), 0, norms2.data_ptr(),
                                     order_.data_ptr(), n_surv_.data_ptr(), out.data_ptr(), n,
                                     128, s.tile_n, s.n_tiles, grid, stream)
        if rc != 0:
            raise RuntimeError(f"threshold_probe: dense launch failed, cudaError {rc}")

    def parent_scan(order_, n_surv_, fill: bool):
        if fill:
            out.fill_(torch.inf)
        chunks = s.n_tiles * -(-s.tile_n // 256)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rc = libs["parent"].innr_threshold_scan(
            q0.data_ptr(), rows.data_ptr(), 0, norms2.data_ptr(), order_.data_ptr(),
            n_surv_.data_ptr(), out.data_ptr(), n, 128, s.tile_n, 256, min(chunks, sms * 8),
            stream)
        if rc != 0:
            raise RuntimeError(f"threshold_probe: parent launch failed, cudaError {rc}")

    head = libs["full"].innr_threshold_header_words(s.tile_n, s.n_tiles)
    buf = torch.empty(head + n + (n + 1) // 2, dtype=torch.int64, device=dev)

    def compact(order_, n_surv_, grid=0):
        rc = libs["full"].innr_threshold_compact(
            q0.data_ptr(), rows.data_ptr(), 0, norms2.data_ptr(), order_.data_ptr(),
            n_surv_.data_ptr(), qq.data_ptr(), thr, buf.data_ptr(), n, 128, s.tile_n, s.n_tiles,
            grid, stream)
        if rc != 0:
            raise RuntimeError(f"threshold_probe: compact launch failed, cudaError {rc}")

    for tag, order_, n_surv_ in ((f"{live} tiles", order, n_surv), ("every tile", every, all_n)):
        for name in ("full", "nofill"):
            note(f"{tag}: dense scan alone, {name}", ms(lambda: dense(libs[name], order_,
                                                                      n_surv_)))
        if parent is not None:
            note(f"{tag}: parent scan alone", ms(lambda: parent_scan(order_, n_surv_, False)))
            note(f"{tag}: parent scan + fill", ms(lambda: parent_scan(order_, n_surv_, True)))
        for grid in GRIDS:
            note(f"{tag}: dense scan alone, full, {grid} CTAs",
                 ms(lambda: dense(libs["full"], order_, n_surv_, grid)))
        note(f"{tag}: threshold_dists", ms(lambda: tpk.threshold_dists(
            q0, rows, norms2, order_, n_surv_, s.tile_n)))
        note(f"{tag}: compact scan alone", ms(lambda: compact(order_, n_surv_)))
        for grid in GRIDS:
            note(f"{tag}: compact scan alone, {grid} CTAs",
                 ms(lambda: compact(order_, n_surv_, grid)))
        note(f"{tag}: compact scan + read M", ms(lambda: (compact(order_, n_surv_),
                                                          buf[1:3].tolist())))

        def fetch(pinned: bool):
            compact(order_, n_surv_)
            m = buf[1:3].tolist()[0]
            if not pinned:
                return buf[head:head + m].cpu(), buf[head + n:].view(torch.float32)[:m].cpu()
            host = torch.empty(m, dtype=torch.int64, pin_memory=True)
            dist = torch.empty(m, dtype=torch.float32, pin_memory=True)
            host.copy_(buf[head:head + m], non_blocking=True)
            dist.copy_(buf[head + n:].view(torch.float32)[:m], non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            return host, dist

        note(f"{tag}: compact scan + read M + copy rows and distances (torch)",
             ms(lambda: fetch(False)))
        note(f"{tag}: compact scan + read M + copy rows and distances (torch, pinned)",
             ms(lambda: fetch(True)))
        note(f"{tag}: threshold_survivors", ms(lambda: tpk.threshold_survivors(
            q0, rows, norms2, qq, order_, n_surv_, s.tile_n, thr)))
    m = len(tpk.threshold_survivors(q0, rows, norms2, qq, order, n_surv, s.tile_n, thr)[0])
    res["kept_rows"] = m
    note("every tile: torch.addmv", ms(lambda: torch.addmv(norms2, rows, q0, alpha=-2.0)))

    def dense_path():
        """The parent's path on this tree's dense kernel: the plain plan,
        the dense call, + qq, the keep-mask, nonzero, two host copies."""
        o, ns, _ = plan_threshold_survivors(q0[None], s.centroids, s.radii, thr)
        dists = tpk.threshold_dists(q0, rows, norms2, o, ns, s.tile_n) + (q0 * q0).sum()
        keep = ~(dists > float(np.float32(thr))) & ~torch.isnan(dists)
        idx = torch.nonzero(keep).flatten()
        return idx.cpu().numpy(), dists[idx].cpu().numpy()

    def call():
        return itt.batch_l2_squared_pruning(q0, vb, thr)

    for name, fn in (("batch_l2_squared_pruning", call),
                     ("the dense path (plain plan, dense call, + qq, mask, nonzero, two "
                      "copies)", dense_path)):
        note(name, ms(fn), f" ({m} rows kept)")
        res[f"profile: {name}"] = profile(fn, res["ms"][name])
    print(json.dumps(res))
    if args:
        Path(args[0]).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
