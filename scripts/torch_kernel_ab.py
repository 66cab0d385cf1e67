#!/usr/bin/env python3
"""A/B of kernels of two innr_tpu_torch trees on one CUDA GPU.

    python3 scripts/torch_kernel_ab.py ROOT TAG OUTDIR [PARTS]  # one tree, one turn
    python3 scripts/torch_kernel_ab.py --compare OUTDIR         # after every turn

A turn imports ``innr_tpu_torch`` from ROOT (a checkout, e.g. a
``git archive`` of the parent commit unpacked under ``build/``), makes the
inputs from fixed seeds on the card, and writes ``OUTDIR/TAG.pt`` with the
results and times (CUDA events, median of 5) of the parts named in PARTS
(comma-separated; all by default):

- ``knn``: K1's raw top-k ``(keys, idx)`` (``kernels.knn.
  fused_knn_keys_batch``) over Gaussian f32 10M x 128 and bf16 20M x 128
  corpora in the dot, l2 and cosine modes at Q in {1, 32} and k in {10,
  1000}; over uniform u8 codes, 1M and 4M x 768, in the same modes at Q in
  {1, 32} and k in {10, 80, 1000} (80: ``TwoStageIndex``'s u8 coarse pass);
  and ``batch_knn_dot(..., prune=True)`` on the clustered,
  cluster-ordered 10M x 128 corpus of ``chip_smoke.py``'s pruning cells
  (Q = 32, k = 10), and the tile scan alone (``kernels.pruned_knn.
  pruned_keys``) on that call's plan;
- ``maxsim``: the f32 MaxSim scores (``kernels.maxsim_kernel.
  fused_maxsim_scores_batch``) over ``chip_smoke.py``'s ColBERT corpus
  (200K x 180 x 128, ragged lengths) at B in {1, 16}, with and without the
  mask;
- ``sparse``: the sparse scan's raw top-k (``kernels.sparse_knn.
  fused_sparse_keys_batch``) over ``chip_smoke.py``'s two 10M x 32 sparse
  corpora (WordPiece and hashed 32-bit ids) at Q in {1, 16}, k in {10,
  1000};
- ``packed``: the packed scan's raw top-k (``kernels.packed_knn.
  fused_packed_keys_batch``) over a binary 30M x 768-bit corpus and a
  ternary 15M x 768 one (random words over all 32 bits, disjoint planes, as
  ``chip_smoke.py`` draws them, made word-major) at Q in {1, 16, 32}, k in
  {10, 640} (640: three passes, the second and third after an exclusion
  bound);
- ``slot``: the slot scan's raw top-k (``kernels.slot_knn.
  fused_slot_keys_batch``) over ``chip_smoke.py``'s MinHash corpora (10M x
  128 uint32 and uint16 slots over the full width, 16 near-duplicate
  queries) and its hit-heavy ones (slots from 4 values, 16 of the rows as
  queries) at Q in {1, 4, 16}, k = 10; and the full-width corpora with
  N + 1 and N + 3 rows (slot rows off 16-byte boundaries) at Q in {1, 4};
- ``threshold``: the threshold scan on ``chip_smoke.py``'s clustered
  10M x 128 cell (query near centre 0, threshold 1.0): the dense form
  (``kernels.pruned_knn.threshold_dists``) on the call's plan and over
  every tile, f32, and on the bf16 corpus's plan; and
  ``batch_l2_squared_pruning`` end to end (CUDA events around the call,
  host copies included), f32 and bf16.

Run the turns as parent, this, this, parent in one call, so that both
trees meet the same card. ``--compare`` holds every turn's results to
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


def maxsim_part(out: dict, times: dict, dev) -> None:
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import maxsim_kernel as tm

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    docs, mask, _ = cs._colbert_corpus(gen, dev)
    qs = torch.randn((16, 32, 128), generator=gen, device=dev)
    qs = qs / qs.norm(dim=2, keepdim=True)
    for n_b in (1, 16):
        for name, m in (("mask", mask), ("nomask", None)):
            key = f"maxsim_f32_b{n_b}_{name}"
            out[key] = (tm.fused_maxsim_scores_batch(qs[:n_b], docs, m).cpu(),)
            times[f"{key}_ms"] = median_ms(lambda: tm.fused_maxsim_scores_batch(qs[:n_b], docs, m))
    del docs, mask
    torch.cuda.empty_cache()


def sparse_part(out: dict, times: dict, dev) -> None:
    """chip_smoke.py's phase_sparse corpora and queries, drawn the same way."""
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import sparse_knn as tsp

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    p = 1.0 / torch.arange(1, cs.VOCAB + 1, dtype=torch.float64, device=dev)
    cdf = (torch.cumsum(p, 0) / p.sum()).float()
    perm = torch.randperm(cs.VOCAB, generator=gen, device=dev).to(torch.int32)
    ranks = torch.stack([torch.multinomial(p.float(), cs.QUERY_NNZ, replacement=False,
                                           generator=gen) for _ in range(16)])
    q_val = torch.randn((16, cs.QUERY_NNZ), generator=gen, device=dev).abs_()
    hashed = torch.randint(-(2**31), 2**31, (cs.VOCAB,), generator=gen, device=dev,
                           dtype=torch.int32)
    hashed[hashed == -1] = 0
    for space in ("wordpiece", "hashed"):
        to_id = perm if space == "wordpiece" else hashed[perm.long()]
        ids, vals = cs._zipf_sparse_corpus(gen, dev, to_id, cdf)
        q_idx, order = cs.unsigned_sort(to_id[ranks], 1)
        qv = torch.gather(q_val, 1, order)
        idx_t, val_t = ids.T.contiguous(), vals.T.contiguous()
        del ids, vals
        for n_q in (1, 16):
            qi, qq = q_idx[:n_q].contiguous(), qv[:n_q].contiguous()
            for k in (10, 1000):
                key = f"sparse_{space}_q{n_q}_k{k}"
                out[key] = tuple(t.cpu() for t in tsp.fused_sparse_keys_batch(qi, qq, idx_t,
                                                                               val_t, k))
                times[f"{key}_ms"] = median_ms(
                    lambda: tsp.fused_sparse_keys_batch(qi, qq, idx_t, val_t, k))
        del idx_t, val_t
        torch.cuda.empty_cache()


def packed_part(out: dict, times: dict, dev) -> None:
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import packed_knn as tp

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    w = 24
    for kind, n in (("binary", 30_000_000), ("ternary", 15_000_000)):
        planes_t = cs.planes(gen, kind, (w, n), dev)
        queries = cs.planes(gen, kind, (32, w), dev)
        for n_q in (1, 16, 32):
            qs = tuple(q[:n_q].contiguous() for q in queries)
            for k in (10, 640):
                key = f"packed_{kind}_q{n_q}_k{k}"
                out[key] = tuple(t.cpu() for t in tp.fused_packed_keys_batch(qs, planes_t, k))
                times[f"{key}_ms"] = median_ms(lambda: tp.fused_packed_keys_batch(qs, planes_t, k))
        del planes_t
        torch.cuda.empty_cache()


def slot_part(out: dict, times: dict, dev) -> None:
    """chip_smoke.py's phase_slot corpora and queries, drawn the same way."""
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import slot_knn as tsl

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    n, n_q = cs.N_SKETCH, 16
    for dtype in (torch.int32, torch.int16):
        bits = torch.iinfo(dtype).bits
        sketches = cs._random_slots(gen, n, cs.SLOTS, dtype, dev)
        rows = torch.arange(n_q, device=dev) * (n // n_q) + 12_345
        sketches[(rows + 1_000_003) % n] = sketches[rows]
        qs = sketches[rows].clone()
        qs[:, :13] = cs._random_slots(gen, n_q, 13, dtype, dev)
        slots_t = sketches.T.contiguous()
        del sketches
        # Then chip_smoke.py's hit-heavy corpus: every slot one of 4 values,
        # 16 of its rows as queries.
        info = torch.iinfo(dtype)
        alphabet = torch.tensor([info.min, -1, 0, 1], dtype=dtype, device=dev)
        for corpus in ("", "_hit_heavy"):
            if corpus:
                for a in range(0, n, 1 << 20):
                    b = min(n, a + (1 << 20))
                    slots_t[:, a:b] = alphabet[torch.randint(0, 4, (cs.SLOTS, b - a),
                                                             generator=gen, device=dev)]
                qs = slots_t[:, rows].T.contiguous()
            for q in (1, 4, n_q):
                qq = qs[:q].contiguous()
                key = f"slot_u{bits}{corpus}_q{q}_k10"
                out[key] = tuple(t.cpu() for t in tsl.fused_slot_keys_batch(qq, slots_t, 10))
                times[f"{key}_ms"] = median_ms(lambda: tsl.fused_slot_keys_batch(qq, slots_t, 10))
            # N + 1 and N + 3 rows: slot rows that start off a 16-byte
            # boundary (the first d rows repeated at the end).
            for d in () if corpus else (1, 3):
                odd = torch.cat([slots_t, slots_t[:, :d]], dim=1)
                for q in (1, 4):
                    qq = qs[:q].contiguous()
                    key = f"slot_u{bits}_n{n + d}_q{q}_k10"
                    out[key] = tuple(t.cpu() for t in tsl.fused_slot_keys_batch(qq, odd, 10))
                    times[f"{key}_ms"] = median_ms(lambda: tsl.fused_slot_keys_batch(qq, odd, 10))
                del odd
        del slots_t
        torch.cuda.empty_cache()


def threshold_part(itt, out: dict, times: dict, dev) -> None:
    """chip_smoke.py's clustered cell and threshold query, drawn the same
    way."""
    import torch

    import chip_smoke as cs
    from innr_tpu_torch.kernels import pruned_knn as tpk
    from innr_tpu_torch.prune import plan_threshold_survivors

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    rows, centers = cs._clustered(gen, cs.N_PRUNE, 256, True, dev)
    q0 = (centers[:32] + 0.01 * torch.randn((32, 128), generator=gen, device=dev))[0].contiguous()
    thr = 1.0
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        vb = itt.VerticalBatch(rows, dtype=dtype)
        s, norms2 = vb.tile_summary(), vb.norms2()
        order, n_surv, _ = plan_threshold_survivors(q0[None], s.centroids, s.radii, thr)
        cells = [("plan", order, n_surv)]
        if name == "f32":
            cells.append(("every_tile", torch.arange(s.n_tiles, dtype=torch.int32, device=dev),
                          torch.full((1,), s.n_tiles, dtype=torch.int32, device=dev)))
        for cell, o, ns in cells:
            key = f"threshold_dense_{name}_{cell}"
            out[key] = (tpk.threshold_dists(q0, vb.rows, norms2, o, ns, s.tile_n).cpu(),)
            times[f"{key}_ms"] = median_ms(
                lambda: tpk.threshold_dists(q0, vb.rows, norms2, o, ns, s.tile_n))
        key = f"batch_l2_squared_pruning_{name}"
        idx, dists = itt.batch_l2_squared_pruning(q0, vb, thr)
        out[key] = (torch.as_tensor(idx), torch.as_tensor(dists))
        times[f"{key}_ms"] = median_ms(lambda: itt.batch_l2_squared_pruning(q0, vb, thr))
        del vb
        torch.cuda.empty_cache()


def turn(root: str, tag: str, outdir: str,
         parts: str = "knn,maxsim,sparse,packed,slot,threshold") -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    sys.path.append(str(Path(__file__).resolve().parent.parent))  # chip_smoke's cells
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import knn as tk

    Path(outdir).mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    out, times = {}, {}
    if "maxsim" in parts.split(","):
        maxsim_part(out, times, dev)
    if "sparse" in parts.split(","):
        sparse_part(out, times, dev)
    if "knn" in parts.split(","):
        knn_part(itt, tk, out, times, dev)
    if "packed" in parts.split(","):
        packed_part(out, times, dev)
    if "slot" in parts.split(","):
        slot_part(out, times, dev)
    if "threshold" in parts.split(","):
        threshold_part(itt, out, times, dev)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.save({"out": out, "times": times, "gpu": gpu, "root": root},
               Path(outdir) / f"{tag}.pt")
    print(json.dumps({"tag": tag, "gpu": gpu, **times}), flush=True)


def knn_part(itt, tk, out: dict, times: dict, dev) -> None:
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    qs = torch.randn((32, 128), generator=gen, device=dev)
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
    q768 = torch.randn((32, 768), generator=gen, device=dev)
    for n in (1_000_000, 4_000_000):
        rows = torch.randint(0, 256, (n, 768), generator=gen, device=dev, dtype=torch.uint8)
        aux = {"dot": None, "l2": tk._norms2(rows), "cosine": tk.inv_norms(rows)}
        for mode in MODES:
            for n_q in (1, 32):
                q = q768[:n_q].contiguous()
                q = tk._unit_queries(q) if mode == "cosine" else q
                for k in (10, 80, 1000):
                    key = f"u8_{n // 1_000_000}M_{mode}_q{n_q}_k{k}"
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
    # K14 alone on the same plan (the tile scan and its merge).
    from innr_tpu_torch.kernels import pruned_knn as tpk

    order, n_surv = tpk.plan(qc, rows, vb.tile_summary(), 10, "dot")
    tile_n = vb.tile_summary().tile_n
    out["k14_f32_dot"] = tuple(t.cpu() for t in tpk.pruned_keys(qc, rows, None, order, n_surv,
                                                                tile_n, 10, "dot"))
    times["k14_f32_dot_ms"] = median_ms(
        lambda: tpk.pruned_keys(qc, rows, None, order, n_surv, tile_n, 10, "dot"))


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
    turn(*sys.argv[1:5])
