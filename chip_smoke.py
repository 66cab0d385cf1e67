#!/usr/bin/env python3
"""Smoke run of innr_tpu_torch's batch-kNN main path on one CUDA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and nvcc (``/usr/local/cuda``), and exits non-zero
without printing a result when either is missing. It never runs on the CPU
and imports nothing of JAX. Phases:

1. build    — compile ``innr_tpu_torch/csrc/*.cu`` with nvcc (sm_90a); print
              the build time, the card's name and power limit, and ptxas'
              register / spill report.
2. exact    — the kNN kernel against its plain PyTorch version on the same
              device tensors, on integer-valued data (every dot and L2 score
              is then exact, so keys and indices must agree bit for bit,
              ties included) for every mode and corpus dtype, Q in {1, 5, 32},
              D in {1, 127, 768}, k in {1, 10, cap + 3} (the last runs two
              passes), N not a multiple of the slab size, with planted NaN,
              +-inf and -0.0 rows. Cosine (unit queries) is held to 1e-5.
3. main     — the public entry points at full size, launch counters reset
              just before: batch_knn_dot / batch_knn / batch_knn_cosine /
              batch_knn_filtered on a 10M x 128 f32 VerticalBatch (32
              queries, k=10), batch_knn_dot on 20M x 128 bf16,
              batch_knn_u8_multi on 1M x 768 u8, the batch_demo
              configuration (10K x 128, 100 queries, top-2) against a float64
              brute force, and k=2048 on the 10M corpus (8 passes). Each
              result is held against the plain version (scores within a
              condition-aware tolerance, indices equal wherever the score
              gap exceeds it); the bf16-vs-f32 top-10 overlap must be >= 0.98.
4. timing   — kernel, plain version and a same-bytes ``torch.sum`` read for
              f32 10M x 128, bf16 20M x 128 and u8 1M x 768 (Q=32, k=10):
              CUDA events, median of 7 after warm-up; roofline fraction =
              read_ms / kernel_ms.

Every failed check raises, so the exit code is non-zero. The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1234
EPS32 = 1.1920928955078125e-07
K_DEMO, N_DEMO, Q_DEMO = 2, 10_000, 100


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def scores_from_keys(keys, mode: str):
    from innr_tpu_torch.utils.order import invert_total_key

    return invert_total_key(~keys if mode in ("l2", "l2m") else keys)


def check_close(name, got_vals, got_idx, want_vals, want_idx, tol) -> float:
    """Scores within ``tol`` (per query, (Q, 1)); indices equal wherever the
    plain ranking separates a rank from both neighbours by more than 2 tol.
    ``want_*`` carry one more rank than ``got_*``. Returns the max abs
    difference over finite scores."""
    import torch

    k = got_vals.shape[1]
    g, w = got_vals.double(), want_vals.double()
    wk = w[:, :k]
    diff = (g - wk).abs()
    same = (torch.isnan(g) & torch.isnan(wk)) | (torch.isinf(g) & (g == wk))
    bad = ~(same | (diff <= tol))
    if bad.any():
        q, j = (int(v) for v in bad.nonzero()[0])
        raise AssertionError(
            f"{name}: score at query {q} rank {j}: kernel {float(g[q, j])!r} "
            f"plain {float(wk[q, j])!r} tol {float(tol[q, 0])!r}"
        )
    inf = torch.full_like(wk[:, :1], float("inf"))
    gap_prev = torch.cat([inf, (wk[:, 1:] - wk[:, :-1]).abs()], dim=1)
    gap_next = (w[:, 1:k + 1] - wk).abs()
    separated = (gap_prev > 2 * tol) & (gap_next > 2 * tol)
    wrong = separated & (got_idx.long() != want_idx[:, :k].long())
    if wrong.any():
        q, j = (int(v) for v in wrong.nonzero()[0])
        raise AssertionError(
            f"{name}: index at query {q} rank {j}: kernel {int(got_idx[q, j])} "
            f"plain {int(want_idx[q, j])}"
        )
    finite = torch.isfinite(diff)
    return float(diff[finite].max()) if finite.any() else 0.0


# -- phase 1 ---------------------------------------------------------------

def phase_build() -> None:
    from innr_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    log(f"[build] gpu: {gpu_name_and_power()}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")


# -- phase 2 ---------------------------------------------------------------

def _int_corpus(gen, n, d, dtype, dev):
    import torch

    if dtype == torch.uint8:
        return torch.randint(0, 256, (n, d), generator=gen, device=dev, dtype=torch.uint8)
    rows = torch.randint(-4, 5, (n, d), generator=gen, device=dev).float()
    rows[3] = float("nan")
    rows[17] = float("inf")
    rows[40] = -float("inf")
    rows[63] = -0.0
    rows[64, : max(1, d // 2)] = float("inf")
    return rows.to(dtype)


def phase_exact(dev) -> int:
    import torch

    from innr_tpu_torch.kernels import knn as tk

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cap = tk.single_pass_k(1)
    n = 3 * 1024 + 77
    checks = 0
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        modes = ("dot",) if dtype == torch.uint8 else (
            "dot", "l2", "cosine", "dotm", "l2m", "cosinem")
        for d in (1, 127, 768):
            rows = _int_corpus(gen, n, d, dtype, dev)
            norms2 = tk._norms2(rows)
            inv = tk.inv_norms(rows)
            mask = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
            aux_by_mode = {
                "dot": None, "l2": norms2, "cosine": inv, "dotm": mask,
                "l2m": torch.stack([norms2, mask]),
                "cosinem": torch.stack([inv, mask]),
            }
            for n_q in (1, 5, 32):
                qs = torch.randint(-4, 5, (n_q, d), generator=gen, device=dev).float()
                qs[0, 0] = 0.0
                for mode in modes:
                    aux = aux_by_mode[mode]
                    q_in = tk._unit_queries(qs) if mode.startswith("cos") else qs
                    for k in (1, 10, cap + 3):
                        name = f"exact {dtype} d={d} q={n_q} {mode} k={k}"
                        keys, idx = tk.fused_knn_keys_batch(q_in, rows, aux, k, mode)
                        if mode.startswith("cos"):
                            pk, pi = tk.knn_plain(q_in, rows, aux, k + 1, mode)
                            tol = torch.full((n_q, 1), 1e-5, dtype=torch.float64, device=dev)
                            check_close(name, scores_from_keys(keys, mode), idx,
                                        scores_from_keys(pk, mode), pi, tol)
                        else:
                            pk, pi = tk.knn_plain(q_in, rows, aux, k, mode)
                            if not (torch.equal(keys, pk) and torch.equal(idx, pi)):
                                bad = (keys != pk) | (idx != pi)
                                q, j = (int(v) for v in bad.nonzero()[0])
                                raise AssertionError(
                                    f"{name}: query {q} rank {j}: kernel "
                                    f"({int(keys[q, j])}, {int(idx[q, j])}) plain "
                                    f"({int(pk[q, j])}, {int(pi[q, j])})"
                                )
                        checks += 1
    torch.cuda.synchronize()
    log(f"[exact] {checks} kernel-vs-plain checks agree (bit-exact; cosine within 1e-5)")
    return checks


# -- phase 3 ---------------------------------------------------------------

def _tol_dot(qs, rows, chunk=1 << 21):
    """32 eps max_r sum_i |q_i r_i| per query, (Q, 1) float64."""
    import torch

    best = torch.zeros(qs.shape[0], dtype=torch.float64, device=qs.device)
    qa = qs.abs()
    for s in range(0, rows.shape[0], chunk):
        part = qa @ rows[s:s + chunk].float().abs().T
        best = torch.maximum(best, part.max(dim=1).values.double())
    return (32 * EPS32 * best)[:, None]


def _plain_vals(qs, rows, aux, k, mode):
    from innr_tpu_torch.kernels import knn as tk

    keys, idx = tk.knn_plain(qs, rows, aux, k, mode)
    return scores_from_keys(keys, mode), idx


def _expect_launch(before: int, name: str) -> int:
    from innr_tpu_torch.kernels import knn as tk

    if tk.LAUNCHES <= before:
        raise AssertionError(f"{name}: no kernel launch recorded")
    return tk.LAUNCHES


def phase_main(dev, corpora: dict, errs: dict) -> dict:
    import numpy as np
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch import backend
    from innr_tpu_torch.kernels import knn as tk

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_q, k = 32, 10

    f32 = torch.randn((10_000_000, 128), generator=gen, device=dev)
    corpora["f32"] = f32
    bf16 = torch.empty((20_000_000, 128), dtype=torch.bfloat16, device=dev)
    for s in range(0, bf16.shape[0], 1_000_000):
        bf16[s:s + 1_000_000] = torch.randn((1_000_000, 128), generator=gen, device=dev)
    corpora["bf16"] = bf16
    codes = torch.randint(0, 256, (1_000_000, 768), generator=gen, device=dev, dtype=torch.uint8)
    corpora["u8"] = codes
    qs128 = torch.randn((n_q, 128), generator=gen, device=dev)
    qs768 = torch.randn((n_q, 768), generator=gen, device=dev)
    corpora["qs128"], corpora["qs768"] = qs128, qs768
    torch.cuda.synchronize()

    vb = itt.VerticalBatch(f32)
    norms2, inv = vb.norms2(), vb.inv_norms()
    mask = torch.rand(f32.shape[0], generator=gen, device=dev) < 0.3
    tol_dot = _tol_dot(qs128, f32)
    qq = (qs128 * qs128).sum(dim=1, keepdim=True).double()
    tol_l2 = 32 * EPS32 * (norms2.max().double() + qq) + 2 * tol_dot
    u8_batch = itt.QuantizedU8Batch(codes)
    params = itt.QuantizationParams.from_range(-1.0, 1.0)
    vb16 = itt.VerticalBatch(bf16, dtype=torch.bfloat16)
    rng = np.random.default_rng(42)
    demo_rows = rng.standard_normal((N_DEMO, 128)).astype(np.float32)
    demo_qs = rng.standard_normal((Q_DEMO, 128)).astype(np.float32)
    demo_vb = itt.VerticalBatch.from_numpy(demo_rows, device=dev)
    torch.cuda.synchronize()
    if itt.config.reference_forced():
        raise AssertionError("force_reference is on; the main path must run the kernel")

    # Main path: counters from zero, public entry points only.
    tk.LAUNCHES = 0
    for name in tk.LAUNCHES_BY_DTYPE:
        tk.LAUNCHES_BY_DTYPE[name] = 0
    results = {}
    for b, size in ((vb, f32.shape[0]), (vb16, bf16.shape[0])):
        if backend.batch_backend(size, b.rows.device) != backend.Backend.CUDA:
            raise AssertionError("batch_backend does not report the CUDA kernel")
    last = 0
    results["dot"] = itt.batch_knn_dot(qs128, vb, k)
    last = _expect_launch(last, "batch_knn_dot f32")
    results["l2"] = itt.batch_knn(qs128, vb, k)
    last = _expect_launch(last, "batch_knn f32")
    results["cosine"] = itt.batch_knn_cosine(qs128, vb, k)
    last = _expect_launch(last, "batch_knn_cosine f32")
    results["filtered"] = itt.batch_knn_filtered(qs128, vb, k, mask)
    last = _expect_launch(last, "batch_knn_filtered f32")
    results["bf16"] = itt.batch_knn_dot(qs128, vb16, k)
    last = _expect_launch(last, "batch_knn_dot bf16")
    results["u8"] = itt.batch_knn_u8_multi(qs768, u8_batch, params, k)
    last = _expect_launch(last, "batch_knn_u8_multi")
    results["demo"] = itt.batch_knn_dot(demo_qs, demo_vb, K_DEMO)
    last = _expect_launch(last, "batch_knn_dot demo")
    results["k2048"] = itt.batch_knn_dot(qs128, vb, 2048)
    last = _expect_launch(last, "batch_knn_dot k=2048")
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES_BY_DTYPE)
    log(f"[main] kernel passes on the main path: {tk.LAUNCHES} {launches}")

    def t(res):
        return (torch.as_tensor(res.scores, device=dev), torch.as_tensor(res.indices, device=dev))

    pv, pi = _plain_vals(qs128, f32, None, k + 1, "dot")
    errs["float32"] = check_close("batch_knn_dot f32", *t(results["dot"]), pv, pi, tol_dot)
    pv, pi = _plain_vals(qs128, f32, norms2, k + 1, "l2")
    pv = (pv.double() + qq).clamp_min(0.0)
    err = check_close("batch_knn f32", *t(results["l2"]), pv, pi, tol_l2)
    errs["float32"] = max(errs["float32"], err)
    unit = tk._unit_queries(qs128)
    pv, pi = _plain_vals(unit, f32, inv, k + 1, "cosine")
    check_close("batch_knn_cosine f32", *t(results["cosine"]), pv, pi,
                torch.full((n_q, 1), 1e-5, dtype=torch.float64, device=dev))
    aux = torch.stack([norms2, mask.float()])
    pv, pi = _plain_vals(qs128, f32, aux, k + 1, "l2m")
    pv = (pv.double() + qq).clamp_min(0.0)
    check_close("batch_knn_filtered f32", *t(results["filtered"]), pv, pi, tol_l2)
    if not bool(mask[torch.as_tensor(results["filtered"].indices, device=dev)].all()):
        raise AssertionError("batch_knn_filtered returned a row that fails the predicate")
    log("[main] f32 10M x 128: batch_knn_dot, batch_knn, batch_knn_cosine, "
        "batch_knn_filtered agree with the plain version")

    pv, pi = _plain_vals(qs128, f32, None, 2049, "dot")
    err = check_close("batch_knn_dot k=2048", *t(results["k2048"]), pv, pi, tol_dot)
    errs["float32"] = max(errs["float32"], err)
    log(f"[main] k=2048 over 10M x 128 ({-(-2048 // tk.single_pass_k(n_q))} passes) agrees")

    tol16 = _tol_dot(qs128.to(torch.bfloat16).float(), bf16)
    pv, pi = _plain_vals(qs128, bf16, None, k + 1, "dot")
    errs["bfloat16"] = check_close("batch_knn_dot bf16", *t(results["bf16"]), pv, pi, tol16)
    del pv, pi
    log("[main] bf16 20M x 128: batch_knn_dot agrees with the plain version")

    mixed, idx = results["u8"]
    keys_p, idx_p = tk.knn_plain(qs768, codes, None, k + 1, "dot")
    want = (float(np.float32(params.alpha / 255.0)) * scores_from_keys(keys_p, "dot")
            + float(np.float32(params.offset)) * qs768.sum(dim=1, keepdim=True))
    tol_u8 = _tol_dot(qs768, codes) * float(np.float32(params.alpha / 255.0)) + 1e-5
    errs["uint8"] = check_close("batch_knn_u8_multi", mixed, idx, want, idx_p, tol_u8)
    log("[main] u8 1M x 768: batch_knn_u8_multi agrees with the plain version")

    dots = demo_rows.astype(np.float64) @ demo_qs.astype(np.float64).T
    brute = np.argsort(-dots, axis=0, kind="stable")[: K_DEMO + 1].T
    top = np.take_along_axis(dots.T, brute, axis=1)
    cond = np.abs(demo_qs).astype(np.float64) @ np.abs(demo_rows).T.astype(np.float64)
    tol = 32 * EPS32 * cond.max(axis=1, keepdims=True)
    demo = results["demo"]
    exact = int((demo.indices == brute[:, :K_DEMO]).all(axis=1).sum())
    check_close("batch_demo", *t(demo), torch.as_tensor(top, device=dev),
                torch.as_tensor(brute, device=dev), torch.as_tensor(tol, device=dev))
    log(f"[main] batch_demo 10K x 128, {Q_DEMO} queries, top-{K_DEMO}: "
        f"{exact}/{Q_DEMO} queries identical to the float64 brute force")

    sub = f32[:1_000_000]
    a = itt.batch_knn_dot(qs128, itt.VerticalBatch(sub), k).indices
    b = itt.batch_knn_dot(qs128, itt.VerticalBatch(sub, dtype=torch.bfloat16), k).indices
    overlap = float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)]))
    log(f"[main] bf16_vs_f32_top10_overlap (1M x 128, 32 queries): {overlap!r}")
    if overlap < 0.98:
        raise AssertionError(f"bf16 vs f32 top-10 overlap {overlap} < 0.98")
    torch.cuda.synchronize()
    return launches


# -- phase 4 ---------------------------------------------------------------

def _median_ms(fn, reps: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_timing(corpora: dict) -> dict:
    import torch

    from innr_tpu_torch.kernels import knn as tk

    out = {}
    for name, rows, qs in (
        ("float32", corpora["f32"], corpora["qs128"]),
        ("bfloat16", corpora["bf16"], corpora["qs128"]),
        ("uint8", corpora["u8"], corpora["qs768"]),
    ):
        kernel = _median_ms(lambda: tk.fused_knn_keys_batch(qs, rows, None, 10, "dot"))
        plain = _median_ms(lambda: tk.knn_plain(qs, rows, None, 10, "dot"))
        # The corpus bytes viewed as float32: a read at full bandwidth (a
        # uint8 sum accumulates in int64 and runs far slower than a read).
        read = _median_ms(lambda: rows.view(torch.float32).sum())
        out[name] = (kernel, plain, read)
        n, d = rows.shape
        log(f"[timing] {name} {n} x {d}, Q={qs.shape[0]}, k=10: kernel {kernel!r} ms, "
            f"plain {plain!r} ms, same-bytes read {read!r} ms, "
            f"roofline fraction (read/kernel) {read / kernel!r}")
    return out


def main() -> int:
    if not (ROOT / "innr_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(innr_tpu_torch/ not found beside this script)")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda", 0)
    phase_build()
    phase_exact(dev)
    corpora, errs = {}, {}
    launches = phase_main(dev, corpora, errs)
    times = phase_timing(corpora)
    record = {"kernels": [
        {
            "name": f"knn_scan+knn_merge<{name}>",
            "route": "cuda",
            "source": "innr_tpu_torch/csrc/knn.cu",
            "replaces": "innr_tpu/kernels/knn.py:197",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name in ("float32", "bfloat16", "uint8")
    ]}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path launched no {name} kernel pass")
    log(gpu_name_and_power())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
