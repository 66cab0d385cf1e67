#!/usr/bin/env python3
"""Smoke run of innr_tpu_torch's main paths on one CUDA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and nvcc (``/usr/local/cuda``), and exits non-zero
without printing a result when either is missing. It never runs on the CPU
and imports nothing of JAX. Phases:

1. build    — compile ``innr_tpu_torch/csrc/*.cu`` with nvcc (sm_90a), one
              process per source; print the build time, the card's name and
              power limit, and ptxas' register / spill report.
2. exact    — every kernel against its plain PyTorch version on the same
              device tensors, bit for bit:
              - the kNN kernel on integer-valued data (every dot and L2 score
                is then exact, so keys and indices must agree, ties
                included) for every mode and corpus dtype, Q in {1, 5, 32},
                D in {1, 127, 768}, k in {1, 10, cap + 3} (the last runs two
                passes), N not a multiple of the slab size, with planted NaN,
                +-inf and -0.0 rows. Cosine (unit queries) is held to 1e-5;
              - the packed kNN scan and the per-row packed scores, binary and
                ternary, on words drawn over all 32 bits (the sign bit of
                the int32 view included), disjoint ternary planes and planted
                duplicate rows (ties go to the lowest row), Q in
                {1, 5, 16, 33}, D in {1, 77, 768} bits, k in {1, 10, cap + 3}.
3. main     — the public entry points at full size, launch counters reset
              just before each path and read just after it:
              a. batch kNN: batch_knn_dot / batch_knn / batch_knn_cosine /
                 batch_knn_filtered on a 10M x 128 f32 VerticalBatch (32
                 queries, k=10), batch_knn_dot on 20M x 128 bf16,
                 batch_knn_u8_multi on 1M x 768 u8, the batch_demo
                 configuration (10K x 128, 100 queries, top-2) against a
                 float64 brute force, and k=2048 on the 10M corpus (8
                 passes). Scores within a condition-aware tolerance of the
                 plain version, indices equal wherever the score gap exceeds
                 it; the bf16-vs-f32 top-10 overlap must be >= 0.98;
              b. packed: binary_knn_batch on a 30M x 768-bit
                 PackedBinaryBatch and ternary_knn_batch on a 15M x 768
                 PackedTernaryBatch (Q=16, k=10), binary_knn / ternary_knn
                 on 1M x 768 (k=40), batch_binary_hamming and
                 batch_ternary_dot over the big corpora's row-major words;
                 counts, dots and indices equal to the plain version's;
              c. TwoStageIndex.search_batch over 1M x 768 f32 rows, 32
                 queries, k=10, in all four coarse kinds (binary rf=64,
                 ternary rf=64, u8 rf=8, matryoshka prefix 128 rf=10); the
                 binary / ternary shortlists equal the plain version's, the
                 u8 / matryoshka ones agree within the kNN tolerance, and the
                 final scores agree with a plain rerank of the plain
                 shortlist. Then recall@10 of the four kinds on a clustered
                 100K x 256 corpus (64 queries, exact top-10 by
                 batch_knn_dot).
4. timing   — kernel, plain version and a same-bytes ``torch.sum`` read
              (CUDA events, median of 7 after warm-up; roofline fraction =
              read_ms / kernel_ms) for f32 10M x 128, bf16 20M x 128 and u8
              1M x 768 (Q=32, k=10), and for each packed kernel at the sizes
              of 3b (with popcounts per ms); the host time of one
              TwoStageIndex.search_batch of 32 queries, host copy included,
              per coarse kind, and its packed passes.

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


def _counted():
    from innr_tpu_torch.kernels import hamming as th
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import packed_knn as tp

    return (
        ("knn_scan+knn_merge", tk, tk.LAUNCHES_BY_DTYPE),
        ("packed_scan", tp, tp.LAUNCHES_BY_KIND),
        ("packed_rows", th, th.LAUNCHES_BY_KIND),
    )


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    for _, mod, by in _counted():
        mod.LAUNCHES = 0
        for key in by:
            by[key] = 0


def read_counts() -> dict:
    """Launches per kernel instance, e.g. ``packed_scan<binary>``."""
    return {f"{name}<{key}>": n for name, _, by in _counted() for key, n in by.items()}


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
                            expect_equal(name, (keys, idx),
                                         tk.knn_plain(q_in, rows, aux, k, mode))
                        checks += 1
    torch.cuda.synchronize()
    log(f"[exact] {checks} kNN kernel-vs-plain checks agree (bit-exact; cosine within 1e-5)")
    return checks


def expect_equal(name: str, got, want) -> None:
    """Raw ``(keys, idx)`` of the kernel and of the plain version, equal."""
    import torch

    (keys, idx), (pk, pi) = got, want
    if not (torch.equal(keys, pk) and torch.equal(idx, pi)):
        bad = (keys != pk) | (idx != pi)
        q, j = (int(v) for v in bad.nonzero()[0])
        raise AssertionError(
            f"{name}: query {q} rank {j}: kernel ({int(keys[q, j])}, {int(idx[q, j])}) "
            f"plain ({int(pk[q, j])}, {int(pi[q, j])})"
        )


def words(gen, shape, dev):
    """Random int32 words over all 32 bits, the sign bit included."""
    import torch

    return torch.randint(-(2**31), 2**31, shape, generator=gen, device=dev, dtype=torch.int32)


def planes(gen, kind: str, shape, dev) -> tuple:
    """One plane of random words (binary) or two disjoint planes (ternary)."""
    a = words(gen, shape, dev)
    if kind == "binary":
        return (a,)
    b = words(gen, shape, dev)
    return (a & b, a & ~b)


def phase_exact_packed(dev) -> int:
    import torch

    from innr_tpu_torch.kernels import hamming as th
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import packed_knn as tp

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cap = tk.single_pass_k(1)
    n = 3 * 1024 + 77
    checks = 0
    for kind in ("binary", "ternary"):
        for d in (1, 77, 768):
            w = -(-d // 32)
            rows = planes(gen, kind, (n, w), dev)
            for p in rows:  # copies of row 5: ties must go to the lowest row
                p[[100, 2000, n - 1]] = p[5].clone()
            rows_t = tuple(p.T.contiguous() for p in rows)
            for n_q in (1, 5, 16, 33):
                qs = planes(gen, kind, (n_q, w), dev)
                for q, p in zip(qs, rows):  # query 0 is row 5: its copies tie
                    q[0] = p[5]
                for k in (1, 10, cap + 3):
                    expect_equal(f"exact packed_scan<{kind}> d={d} q={n_q} k={k}",
                                 tp.fused_packed_keys_batch(qs, rows_t, k),
                                 tp.packed_knn_plain(qs, rows_t, k))
                    checks += 1
            q1 = tuple(q[0] for q in planes(gen, kind, (1, w), dev))
            if not torch.equal(th.packed_rows(q1, rows), th.hamming_rows_plain(q1, rows)):
                raise AssertionError(f"exact packed_rows<{kind}> d={d}: kernel != plain")
            checks += 1
    torch.cuda.synchronize()
    log(f"[exact] {checks} packed kernel-vs-plain checks agree bit for bit")
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
    reset_counts()
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
    launches = read_counts()
    log(f"[main] kernel passes on the batch-kNN path: {tk.LAUNCHES} {launches}")

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


def _timed(name: str, kernel, plain, read, pops: int) -> tuple:
    """Kernel, plain and same-bytes read medians; logs the roofline fraction
    and popcounts per ms (``pops`` popcounts per call)."""
    k_ms, p_ms, r_ms = _median_ms(kernel), _median_ms(plain), _median_ms(read)
    log(f"[timing] {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms, same-bytes read "
        f"{r_ms!r} ms, roofline fraction (read/kernel) {r_ms / k_ms!r}, "
        f"popcounts per ms {pops / k_ms!r}")
    return k_ms, p_ms, r_ms


def _check_path(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"the {path} path launched no {name}")


def phase_packed(dev) -> tuple[dict, dict, dict]:
    """3b and its timing: the packed families at full size. Returns the
    path's launches, and per kernel its times and max abs error."""
    import numpy as np
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import hamming as th
    from innr_tpu_torch.kernels import packed_knn as tp
    from innr_tpu_torch.ops.binary import binary_knn_batch
    from innr_tpu_torch.ops.ternary import ternary_knn_batch

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    d, w, n_q, k, k1, n1 = 768, 24, 16, 10, 40, 1_000_000
    # Containers from random device words: an f32 corpus of 30M x 768 would
    # not fit the card.
    bb = itt.PackedBinaryBatch(words(gen, (30_000_000, w), dev), d)
    tb = itt.PackedTernaryBatch(*planes(gen, "ternary", (15_000_000, w), dev), d)
    bb1 = itt.PackedBinaryBatch(bb.words[:n1], d)
    tb1 = itt.PackedTernaryBatch(tb.pos[:n1], tb.neg[:n1], d)
    (qb,), (qtp, qtn) = planes(gen, "binary", (n_q, w), dev), planes(gen, "ternary", (n_q, w), dev)
    q1b, q1t = itt.PackedBinary(qb[0], d), itt.PackedTernary(qtp[0], qtn[0], d)
    torch.cuda.synchronize()
    if itt.config.reference_forced():
        raise AssertionError("force_reference is on; the main path must run the kernels")

    reset_counts()
    res = {
        "binary": binary_knn_batch(qb, bb, k),
        "ternary": ternary_knn_batch((qtp, qtn), tb, k),
        "binary1": itt.binary_knn(q1b, bb1, k1),
        "ternary1": itt.ternary_knn(q1t, tb1, k1),
        "hamming": itt.batch_binary_hamming(q1b, bb.words),
        "tdot": itt.batch_ternary_dot(q1t, tb.pos, tb.neg),
    }
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[main] kernel passes on the packed path: {launches}")
    _check_path("packed", launches, [f"{n}<{kind}>" for n in ("packed_scan", "packed_rows")
                                     for kind in ("binary", "ternary")])

    def same(name, got, want) -> None:
        """Kernel and plain results equal, element for element."""
        for g, p in zip(got, want, strict=True):
            g = np.asarray(g.cpu() if torch.is_tensor(g) else g, np.int64)
            if not np.array_equal(g, np.asarray(p.cpu(), np.int64)):
                raise AssertionError(f"{name}: kernel result != plain version")

    def counts(keys_idx):
        return -keys_idx[0], keys_idx[1]

    def first(keys_idx):
        return keys_idx[0][0], keys_idx[1][0]

    same("binary_knn_batch 30M", res["binary"],
         counts(tp.packed_knn_plain((qb,), (bb.words_t,), k)))
    same("binary_knn 1M", res["binary1"],
         counts(first(tp.packed_knn_plain((qb[:1],), (bb1.words_t,), k1))))
    same("ternary_knn_batch 15M", res["ternary"],
         tp.packed_knn_plain((qtp, qtn), (tb.pos_t, tb.neg_t), k))
    same("ternary_knn 1M", res["ternary1"],
         first(tp.packed_knn_plain((qtp[:1], qtn[:1]), (tb1.pos_t, tb1.neg_t), k1)))
    same("batch_binary_hamming 30M", (res["hamming"],),
         (th.hamming_rows_plain((qb[0],), (bb.words,)),))
    same("batch_ternary_dot 15M", (res["tdot"],),
         (th.hamming_rows_plain((qtp[0], qtn[0]), (tb.pos, tb.neg)),))
    log("[main] packed 30M / 15M x 768 bits (Q=16, k=10), 1M (Q=1, k=40) and the "
        "per-row scores agree with the plain version bit for bit")
    # The packed checks above are exact: every packed kernel's error is 0.
    errs = {name: 0.0 for name in ("packed_scan<binary>", "packed_scan<ternary>",
                                   "packed_rows<binary>", "packed_rows<ternary>")}

    times = {}
    scan_pops = 30_000_000 * w * n_q  # ternary: 2 popcounts a word over half the rows
    times["packed_scan<binary>"] = _timed(
        f"packed_scan<binary> 30M x {d} bits, Q={n_q}, k={k}",
        lambda: tp.fused_packed_keys_batch((qb,), (bb.words_t,), k),
        lambda: tp.packed_knn_plain((qb,), (bb.words_t,), k),
        lambda: bb.words_t.view(torch.float32).sum(), scan_pops)
    times["packed_scan<ternary>"] = _timed(
        f"packed_scan<ternary> 15M x {d}, Q={n_q}, k={k}",
        lambda: tp.fused_packed_keys_batch((qtp, qtn), (tb.pos_t, tb.neg_t), k),
        lambda: tp.packed_knn_plain((qtp, qtn), (tb.pos_t, tb.neg_t), k),
        lambda: tb.pos_t.view(torch.float32).sum() + tb.neg_t.view(torch.float32).sum(),
        scan_pops)
    _timed(f"packed_scan<binary> 1M x {d} bits, Q=1, k={k1}",
           lambda: tp.fused_packed_keys_batch((qb[:1],), (bb1.words_t,), k1),
           lambda: tp.packed_knn_plain((qb[:1],), (bb1.words_t,), k1),
           lambda: bb1.words_t.view(torch.float32).sum(), n1 * w)
    _timed(f"packed_scan<ternary> 1M x {d}, Q=1, k={k1}",
           lambda: tp.fused_packed_keys_batch((qtp[:1], qtn[:1]), (tb1.pos_t, tb1.neg_t), k1),
           lambda: tp.packed_knn_plain((qtp[:1], qtn[:1]), (tb1.pos_t, tb1.neg_t), k1),
           lambda: tb1.pos_t.view(torch.float32).sum() + tb1.neg_t.view(torch.float32).sum(),
           2 * n1 * w)
    times["packed_rows<binary>"] = _timed(
        f"packed_rows<binary> 30M x {d} bits",
        lambda: th.packed_rows((qb[0],), (bb.words,)),
        lambda: th.hamming_rows_plain((qb[0],), (bb.words,)),
        lambda: bb.words.view(torch.float32).sum(), 30_000_000 * w)
    times["packed_rows<ternary>"] = _timed(
        f"packed_rows<ternary> 15M x {d}",
        lambda: th.packed_rows((qtp[0], qtn[0]), (tb.pos, tb.neg)),
        lambda: th.hamming_rows_plain((qtp[0], qtn[0]), (tb.pos, tb.neg)),
        lambda: tb.pos.view(torch.float32).sum() + tb.neg.view(torch.float32).sum(),
        2 * 15_000_000 * w)
    return launches, times, errs


def _median_host_ms(fn, reps: int = 7) -> float:
    """Host-clock median of ``fn`` (which waits for its own result)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_pipeline(dev, errs: dict) -> dict:
    """3c and its timing: TwoStageIndex in all four coarse kinds, then the
    recall of each on a clustered corpus."""
    import numpy as np
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.pipeline import rerank

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, d, n_q, k = 1_000_000, 768, 32, 10
    rows = torch.randn((n, d), generator=gen, device=dev)
    qs = torch.randn((n_q, d), generator=gen, device=dev)
    kinds = (
        ("binary", itt.CoarseConfig("binary"), 64),
        ("ternary", itt.CoarseConfig("ternary"), 64),
        ("u8", itt.CoarseConfig("u8"), 8),
        ("matryoshka", itt.CoarseConfig("matryoshka", prefix_dims=128), 10),
    )
    indexes = {kind: itt.TwoStageIndex(rows, cfg, rerank_factor=rf) for kind, cfg, rf in kinds}
    torch.cuda.synchronize()

    # The kernel each kind's coarse stage runs; only that kind launches it.
    coarse_kernel = {
        "binary": "packed_scan<binary>", "ternary": "packed_scan<ternary>",
        "u8": "knn_scan+knn_merge<uint8>", "matryoshka": "knn_scan+knn_merge<float32>",
    }
    reset_counts()
    results = {kind: index.search_batch(qs, k) for kind, index in indexes.items()}
    launches = read_counts()
    log(f"[main] kernel passes on the TwoStageIndex path: {launches}")
    _check_path("TwoStageIndex", launches, coarse_kernel.values())

    tol_fine = _tol_dot(qs, rows)
    for kind, index in indexes.items():
        n_cand = k * index.rerank_factor
        keys, cand = index.candidates(qs, n_cand)
        itt.config.force_reference(True)
        try:
            pkeys, pcand = index.candidates(qs, n_cand + 1)
        finally:
            itt.config.force_reference(False)
        got = results[kind]
        pv, pi = rerank(rows, qs, pcand[:, :n_cand], k + 1)
        if kind in ("binary", "ternary"):
            expect_equal(f"TwoStageIndex {kind} shortlist", (keys, cand),
                         (pkeys[:, :n_cand], pcand[:, :n_cand]))
            if not (np.array_equal(got.indices, pi[:, :k].cpu().numpy())
                    and np.array_equal(got.scores, pv[:, :k].cpu().numpy())):
                raise AssertionError(f"TwoStageIndex {kind}: result != plain rerank")
        else:
            coarse = index._coarse.codes if kind == "u8" else index._coarse
            cq = qs if kind == "u8" else qs[:, : coarse.shape[1]]
            err = check_close(f"TwoStageIndex {kind} shortlist",
                              scores_from_keys(keys, "dot"), cand,
                              scores_from_keys(pkeys, "dot"), pcand, _tol_dot(cq, coarse))
            name = "uint8" if kind == "u8" else "float32"
            errs[name] = max(errs[name], err)
            check_close(f"TwoStageIndex {kind} result",
                        torch.as_tensor(got.scores, device=dev),
                        torch.as_tensor(got.indices, device=dev), pv, pi, tol_fine)
    log("[main] TwoStageIndex 1M x 768, 32 queries, k=10: binary and ternary shortlists "
        "and results equal the plain version's; u8 and matryoshka agree within tolerance")

    for kind, index in indexes.items():
        n_cand = k * index.rerank_factor
        ms = _median_host_ms(lambda: index.search_batch(qs, k))
        log(f"[timing] TwoStageIndex.search_batch {kind} rf={index.rerank_factor} "
            f"(1M x {d}, 32 queries, k={k}, host copy included): {ms!r} ms per batch, "
            f"{n_cand} candidates in {launches[coarse_kernel[kind]]} coarse pass(es)")
    del indexes, rows

    rng = np.random.default_rng(SEED)
    n_r, d_r = 100_000, 256
    centers = rng.standard_normal((256, d_r)).astype(np.float32)
    rows_r = (centers[rng.integers(0, 256, n_r)]
              + 0.3 * rng.standard_normal((n_r, d_r)).astype(np.float32))
    qs_r = rows_r[:64] + 0.05 * rng.standard_normal((64, d_r)).astype(np.float32)
    recall = {
        f"{kind}_rf{rf}": itt.TwoStageIndex(rows_r, kind, rerank_factor=rf, device=dev)
        .recall_vs_exact(qs_r, 10)
        for kind, rf in (("binary", 64), ("ternary", 64), ("u8", 8), ("matryoshka", 8))
    }
    log(f"[main] two_stage_recall_at_10 (clustered 100K x 256, 64 queries): {recall}")
    return launches


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
    phase_exact_packed(dev)
    corpora, errs = {}, {}
    launches = phase_main(dev, corpora, errs)
    _check_path("batch-kNN", launches,
                [f"knn_scan+knn_merge<{name}>" for name in ("float32", "bfloat16", "uint8")])
    times = {f"knn_scan+knn_merge<{name}>": t for name, t in phase_timing(corpora).items()}
    corpora.clear()
    torch.cuda.empty_cache()
    packed_launches, packed_times, packed_errs = phase_packed(dev)
    times.update(packed_times)
    torch.cuda.empty_cache()
    pipeline_launches = phase_pipeline(dev, errs)
    for counts in (packed_launches, pipeline_launches):
        for name, n in counts.items():
            launches[name] += n
    errs = {f"knn_scan+knn_merge<{name}>": err for name, err in errs.items()} | packed_errs
    kernels = [
        ("knn_scan+knn_merge<float32>", "knn.cu", "knn.py:197"),
        ("knn_scan+knn_merge<bfloat16>", "knn.cu", "knn.py:197"),
        ("knn_scan+knn_merge<uint8>", "knn.cu", "knn.py:197"),
        ("packed_scan<binary>", "packed_knn.cu", "packed_knn.py:93,150"),
        ("packed_scan<ternary>", "packed_knn.cu", "packed_knn.py:228,292"),
        ("packed_rows<binary>", "packed.cu", "hamming.py:32"),
        ("packed_rows<ternary>", "packed.cu", "hamming.py:62"),
    ]
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"innr_tpu_torch/csrc/{source}",
            "replaces": f"innr_tpu/kernels/{replaces}",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name, source, replaces in kernels
    ]}
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
