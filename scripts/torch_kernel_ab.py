#!/usr/bin/env python3
"""A/B of the kNN scan (K1) and the tile scan (K14) of two innr_tpu_torch
trees on one CUDA GPU.

    python3 scripts/torch_kernel_ab.py ROOT TAG OUTDIR   # one tree, one turn
    python3 scripts/torch_kernel_ab.py --compare OUTDIR  # after every turn

A turn imports ``innr_tpu_torch`` from ROOT (a checkout, e.g. a
``git archive`` of the parent commit unpacked under ``build/``), makes the
inputs from fixed seeds on the card, and writes ``OUTDIR/TAG.pt``: K1's raw
top-k ``(keys, idx)`` (``kernels.knn.fused_knn_keys_batch``) over Gaussian
f32 10M x 128 and bf16 20M x 128 corpora in the dot, l2 and cosine modes at
Q in {1, 32} and k in {10, 1000}, and ``batch_knn_dot(..., prune=True)`` on
the clustered, cluster-ordered 10M x 128 corpus of ``chip_smoke.py``'s
pruning cells (Q = 32, k = 10), with the times of each (CUDA events, median
of 5). Run the turns as parent, this, this, parent in one call, so that
both trees meet the same card. ``--compare`` holds every turn's results to
the first turn's, bit for bit, and prints one JSON object of the times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 1234
MODES = ("dot", "l2", "cosine")


def median_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def gaussian(gen, n: int, dtype, dev):
    import torch

    rows = torch.empty((n, 128), dtype=dtype, device=dev)
    for a in range(0, n, 1 << 21):
        b = min(n, a + (1 << 21))
        rows[a:b] = torch.randn((b - a, 128), generator=gen, device=dev)
    return rows


def clustered(gen, n: int, n_centers: int, dev):
    """``chip_smoke.py``'s clustered corpus: rows near Gaussian centres
    (sigma 0.05), ordered by centre, and near-centre queries."""
    import torch

    centers = torch.randn((n_centers, 128), generator=gen, device=dev)
    assign = torch.sort(torch.randint(0, n_centers, (n,), generator=gen, device=dev)).values
    rows = torch.empty((n, 128), device=dev)
    for a in range(0, n, 1 << 21):
        b = min(n, a + (1 << 21))
        rows[a:b] = centers[assign[a:b]] + 0.05 * torch.randn((b - a, 128), generator=gen,
                                                              device=dev)
    return rows, centers


def turn(root: str, tag: str, outdir: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import knn as tk

    Path(outdir).mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qs = torch.randn((32, 128), generator=gen, device=dev)
    out, times = {}, {}
    for name, n, dtype in (("f32", 10_000_000, torch.float32),
                           ("bf16", 20_000_000, torch.bfloat16)):
        rows = gaussian(gen, n, dtype, dev)
        aux = {"dot": None, "l2": tk._norms2(rows), "cosine": tk.inv_norms(rows)}
        for mode in MODES:
            for n_q in (1, 32):
                q = qs[:n_q].contiguous()
                q = tk._unit_queries(q) if mode == "cosine" else q
                for k in (10, 1000):
                    key = f"{name}_{mode}_q{n_q}_k{k}"
                    out[key] = tuple(t.cpu() for t in tk.fused_knn_keys_batch(
                        q, rows, aux[mode], k, mode))
                    times[f"{key}_ms"] = median_ms(
                        lambda: tk.fused_knn_keys_batch(q, rows, aux[mode], k, mode))
        del rows, aux
        torch.cuda.empty_cache()
    rows, centers = clustered(gen, 10_000_000, 256, dev)
    qc = centers[:32] + 0.01 * torch.randn((32, 128), generator=gen, device=dev)
    vb = itt.VerticalBatch(rows)
    vb.tile_summary()
    res = itt.batch_knn_dot(qc, vb, 10, prune=True)
    out["prune_f32_dot"] = (torch.as_tensor(res.scores), torch.as_tensor(res.indices))
    times["prune_f32_dot_ms"] = median_ms(lambda: itt.batch_knn_dot(qc, vb, 10, prune=True))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.save({"out": out, "times": times, "gpu": gpu, "root": root},
               Path(outdir) / f"{tag}.pt")
    print(json.dumps({"tag": tag, "gpu": gpu, **times}), flush=True)


def compare(outdir: str) -> int:
    import torch

    runs = sorted(Path(outdir).glob("*.pt"), key=lambda p: p.stat().st_mtime)
    loaded = [(p.stem, torch.load(p)) for p in runs]
    first_tag, first = loaded[0]
    ok = True
    for tag, run in loaded[1:]:
        differ = [key for key, want in first["out"].items()
                  if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                             for g, w in zip(run["out"][key], want))]
        ok &= not differ
        print(f"{tag} vs {first_tag}: {len(first['out']) - len(differ)} of {len(first['out'])} "
              f"results identical" + (f"; DIFFERENT: {differ}" if differ else ""))
    print(json.dumps({"gpu": first["gpu"], "turns": [{"tag": t, **r["times"]}
                                                      for t, r in loaded]}))
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2]))
    turn(*sys.argv[1:4])
