#!/usr/bin/env python3
"""A/B of the nearest-centroid (K13) and bf16 MaxSim (K12) kernels of two
innr_tpu_torch trees on one CUDA GPU.

    python3 scripts/torch_kernel_ab.py ROOT TAG OUTDIR   # one tree, one turn
    python3 scripts/torch_kernel_ab.py --compare OUTDIR  # after every turn

A turn imports ``innr_tpu_torch`` from ROOT (a checkout, e.g. a
``git archive`` of the parent commit unpacked under ``build/``), makes the
inputs from fixed seeds on the card, and writes ``OUTDIR/TAG.pt``: the
K13 assignments at KC = 256 and 16,896 over 10M x 128 clustered f32 rows
(the size of ``chip_smoke.py``'s pruning cells), and the times (CUDA events,
median of 5; 3 at KC = 16,896) of K13 at both KC and of K12 over 200K x 180
x 128 bf16 ColBERT tokens at B = 16. Run the turns as parent, this, this,
parent in one call, so that both trees meet the same card. ``--compare``
holds every turn's assignments to the first turn's, bit for bit, and prints
one JSON object of the times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 1234


def median_ms(fn, reps: int) -> float:
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


def clustered(gen, n: int, n_centers: int, dev):
    """n rows near n_centers Gaussian centres (sigma 0.05), in random order."""
    import torch

    centers = torch.randn((n_centers, 128), generator=gen, device=dev)
    assign = torch.randint(0, n_centers, (n,), generator=gen, device=dev)
    rows = torch.empty((n, 128), device=dev)
    for a in range(0, n, 1 << 21):
        b = min(n, a + (1 << 21))
        rows[a:b] = centers[assign[a:b]] + 0.05 * torch.randn((b - a, 128), generator=gen,
                                                              device=dev)
    return rows, centers


def colbert_bf16(gen, dev, n=200_000, td=180, d=128):
    """Unit-norm bf16 tokens, lengths clip(round(N(80, 30)), 8, 180) as a mask."""
    import torch

    docs = torch.empty((n, td, d), dtype=torch.bfloat16, device=dev)
    for a in range(0, n, 1 << 14):
        b = min(n, a + (1 << 14))
        x = torch.randn((b - a, td, d), generator=gen, device=dev)
        docs[a:b] = (x / x.norm(dim=2, keepdim=True)).to(torch.bfloat16)
    lengths = (torch.randn(n, generator=gen, device=dev) * 30 + 80).round().clamp(8, td).long()
    return docs, torch.arange(td, device=dev)[None, :] < lengths[:, None]


def turn(root: str, tag: str, outdir: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from innr_tpu_torch.kernels import assign as ta
    from innr_tpu_torch.kernels import maxsim_kernel as tm

    Path(outdir).mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, centers = clustered(gen, 10_000_000, 256, dev)
    out, times = {}, {}
    for kc, reps in ((256, 5), (16_896, 3)):
        cent = (centers if kc == 256 else torch.randn((kc, 128), generator=gen, device=dev))
        cent = cent + 0.1 * torch.randn(cent.shape, generator=gen, device=dev)
        out[f"k13_{kc}"] = ta.nearest_centroid(rows, cent).cpu()
        times[f"k13_{kc}_ms"] = median_ms(lambda: ta.nearest_centroid(rows, cent), reps)
    del rows
    torch.cuda.empty_cache()
    docs, mask = colbert_bf16(gen, dev)
    qs = torch.randn((16, 32, 128), generator=gen, device=dev)
    qs = qs / qs.norm(dim=2, keepdim=True)
    out["k12_bf16"] = tm.fused_maxsim_scores_batch(qs, docs, mask).cpu()
    times["k12_bf16_b16_ms"] = median_ms(lambda: tm.fused_maxsim_scores_batch(qs, docs, mask), 5)
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
        for key in ("k13_256", "k13_16896"):
            same = torch.equal(run["out"][key], first["out"][key])
            ok &= same
            print(f"{tag} vs {first_tag} {key}: {'identical' if same else 'DIFFERENT'}")
        err = float((run["out"]["k12_bf16"] - first["out"]["k12_bf16"]).abs().max())
        print(f"{tag} vs {first_tag} k12_bf16 max abs difference {err!r}")
    print(json.dumps({"gpu": first["gpu"], "turns": [{"tag": t, **r["times"]}
                                                      for t, r in loaded]}))
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2]))
    turn(*sys.argv[1:4])
