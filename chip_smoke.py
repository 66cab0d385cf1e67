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
              device tensors, bit for bit (NaN payloads canonicalised):
              - the kNN kernel (tensor-core scores, an exact re-score
                within a proven margin) on
                integer-valued data (every dot and L2 score
                is then exact, so keys and indices must agree, ties
                included) for every mode and corpus dtype, Q in {1, 5, 32},
                D in {1, 127, 768}, k in {1, 10, cap + 3} (the last runs two
                passes), N not a multiple of the slab size, with planted NaN,
                +-inf and -0.0 rows. Cosine (unit queries) is held to 1e-5;
              - the packed kNN scan (b1 tensor cores) and the per-row packed
                scores, binary and ternary (disjoint and overlapping planes),
                on words drawn over all 32 bits (the sign bit of the int32
                view included), planted duplicate, all-zero and all-ones rows
                (ties go to the lowest row), N = 1 and 0 mod 4 (word and
                16-byte loads), Q in {1, 5, 16, 32, 33, 64} (query tiles 8
                to 64), D in {1, 77, 288, 768, 2048} bits, k in {1, 10, cap,
                cap + 3} (the last resumes after an exclusion bound); then
                queries too wide to stay resident (W = 8000 binary, 4000
                ternary), staged per item;
              - the tile scan (knn_scan over a survivor tile list) in all six
                modes, f32 and bf16, D in {127, 128}, Q in {1, 5, 32}, k in
                {1, 10, cap + 3}, tile heights {128, 200, 4736} (N ragged),
                plans with no, one, every and a scattered set of tiles, on
                the kNN phase's corpus (NaN, +-inf, -0.0 rows) with planted
                duplicate rows; also against K1's full scan on full plans;
              - the threshold scan, f32 and bf16, D in {1, 127, 128, 768}:
                the dense form against its plain version, and the
                compacted form against the dense kernel's rows under the
                keep-mask at thresholds that keep nothing, some and every
                live row; the threshold plan's kernel against
                plan_threshold_survivors (1 to 16,896 tiles, Q 1 and 3, NaN
                radii, thresholds -inf to +inf and NaN), exactly;
              - K1's tensor-core scan, full and tile scan, on exact
                arithmetic its products cannot represent: f32 rows of odd
                integers in [2049, 4095] (TF32 drops the low bit), bf16
                rows +-2^e (1 + j/16) whose near ties only the tensor
                core's accumulation separates, u8 codes against queries
                with 18 significant bits (the hi/lo bf16 split drops
                some), planted duplicates and near ties, integer queries;
                six modes, D in {1, 127, 128, 768}, Q in {1, 5, 32, 67},
                k in {1, 10, cap + 3}, and 1M rows at D = 128 (u8: 768);
                with the re-scored pairs per query;
              - K1's wide schedule (f32, many queries) on the same exact
                inputs (odd-integer rows with near ties, then the 3xTF32
                residue queries), held to it by the planner's override:
                D in {32, 64, 96}, Q in {256, 1000}, six modes, k in
                {1, 10, 12}; then 10M rows at D = 64 and 96, Q = 10,000
                (dot and l2m on integer queries, dot on residue queries,
                k = 10): bit for bit the plain version's (taken 64 queries
                at a time) and the tile schedule's;
              - the nearest-centroid pass, f32 / bf16 / u8 rows, D in
                {7, 128, 300}, KC in {1, 3, 256, 2049, 16896}, with exact
                ties and an all-NaN row; and its tensor-core shortlist on
                dots exact in FP32 but not in TF32 (centroids on the 2^-12
                grid, near ties 1-2 grid units apart), D in {8, 128, 130},
                KC in {1, 255, 256, 16896}, with the shortlist sizes;
              - the slot scans, compare and table, uint16 and uint32, on
                slots from a 4-value alphabet drawn over the full width
                (counts tie, nearly every table lookup hits) and on slots
                over the whole width, with planted duplicate rows and
                queries sharing values, Q in {1, 2, 4, 16, 32, 33}, S in
                {1, 7, 128, 256}, k in {1, 10, cap + 3}, N = 3080 and 3077
                (slot rows on and off 16-byte boundaries); a raw (N, S)
                corpus too; 2000 slots at Q = 16 (the compare scan, where
                no table fits);
              - the sparse scan on integer values: ids over the full 32
                bits with sentinel padding and empty documents, duplicate
                query ids, NaN / +-inf / -0.0 values on matched and
                unmatched entries, Lq in {1, 64, 256, 300}, L in {1, 32,
                200}, k in {1, 10, cap + 3}, Q in {1, 16} (one launch, some
                queries padded with the sentinel); then its query tile's
                union table: queries sharing most ids, duplicates, ids >=
                2^31 and the sentinel, non-finite values held by some
                queries only, Q in {5, 13, 16}, a table split into tiles;
              - the MaxSim scan on integer-valued tokens, f32 and bf16
                documents, Tq in {1, 7, 32, 33}, Td in {1, 5, 180}, D in
                {1, 96, 128, 130}, B in {1, 3, 16, 17}, N = 1037, no mask,
                ragged masks with a fully masked document and scattered
                masks, planted NaN / +inf / -inf tokens, an inf in query 1
                of each batch (every query's row equals its single-query
                launch: ROADMAP R7) and the top-k with tied documents;
                then long documents that the bf16 kernel cuts into
                segments (Td 700 at B = 16, Td 60 at D = 1024) and a query
                of 700 tokens that it scores in two passes; then the f32
                kernel's TF32 gate on near ties (odd-integer tokens
                2049-4095 that TF32 truncates, token pairs whose TF32 dots
                tie and exact dots differ by 1-3), masks, NaN / +-inf, R7,
                Tq 200, D in {20, 128, 130, 1024}, B 16 (two query tiles),
                Td 1500 (many items, two segments), with the re-scored
                pairs.
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
                 batch_knn_dot);
              d. pruning (N_PRUNE = 10M x 128): batch_knn_dot / batch_knn /
                 batch_knn_cosine with prune=True on the JAX bench's
                 clustered, cluster-ordered corpus (256 centres, 32
                 near-centre queries, k=10), f32 and bf16, and batch_knn_dot
                 on the Gaussian corpus of 3a (nothing prunes): bit for bit
                 the full scan's result, with no K1 launch;
                 batch_knn_adaptive equal to batch_knn;
                 batch_l2_squared_pruning (threshold 1.0, f32 and bf16: one
                 plan and one compacting launch, no dense one) against a
                 plain full pass, its plan equal to plan_threshold_survivors',
                 and the compacted scan bit for bit the dense kernel's rows
                 under the keep-mask, at 1.0 and at +inf (every row);
                 VerticalBatch.cluster_reorder of the unordered corpus
                 (256 clusters), then prune=True mapped back through perm;
                 IVFIndex (16896 clusters, dot, n_iters=3) against
                 batch_knn_dot;
              e. MinHash: slot_knn_u32_batch (Q=16), slot_knn_u32 (Q=1) and
                 minhash_knn_batch (k=10) on a 10M x 128 uint32
                 SketchCorpus of random slots with near-duplicate queries
                 planted, then the same on a 10M x 128 uint16 corpus; counts
                 and indices equal to the plain version's; then a hit-heavy
                 10M x 128 corpus per width (slots from 4 values, 16 of its
                 rows as queries) at Q = 16 and 1, equal to the plain
                 version;
              f. sparse: sparse_knn (a 64-entry query) and sparse_knn_batch
                 (16 of them), k=10, on a SparseCorpus of 10M documents x
                 32 entries, ids from a Zipf law (exponent 1) over the
                 30,522-id WordPiece vocabulary, values |N(0, 1)|, repeats
                 as sentinel padding; then on a corpus whose ids are hashed
                 over the full 32 bits. Scores within tolerance of the plain
                 version, indices equal where the score gap exceeds it;
              g. MaxSim: maxsim_knn (Q=1) and maxsim_knn_batch (B=16), k=10,
                 over 200K documents x 180 x 128 f32 tokens (ColBERTv2's
                 widths; lengths clip(round(N(80, 30)), 8, 180) as a bool
                 mask), queries of 32 noisy tokens of a planted document,
                 and the kernel module's fused_maxsim_knn_batch on the same
                 corpus in bf16: within tolerance of the plain version, every
                 planted document first.
4. timing   — kernel, plain version and a same-bytes ``torch.sum`` read
              (CUDA events, median of 7 after warm-up; roofline fraction =
              read_ms / kernel_ms; share = bound / kernel) for f32 10M x
              128, bf16 20M x 128 and u8 1M x 768 (Q=32, k=10) with the
              pairs K1 re-scored, f32 and u8 at Q=1, and u8 4M x 768 at
              Q=32 and Q=1; K1 over 10M unit f32 rows at D = 96 and 128,
              Q in {256, 1000, 10,000}, k = 10, dot: the planner's
              schedule within the tolerance of 3a of the plain version (64
              queries at a time), the wide schedule (D = 96: at D = 128 it
              has no layout) bit for bit the tile one's, each schedule's
              kernel ms beside the bound; for each packed kernel at the sizes
              of 3b (with word scores per ms), and the packed scan at
              TwoStageIndex's coarse shape (1M rows, Q=32, k=256, equal to
              the plain version first); the host time of one
              TwoStageIndex.search_batch of 32 queries, host copy included,
              per coarse kind, and its packed passes; the pruned scan (tile
              kernel, prune=True end to end, plain) against K1's full scan
              and reads of all / the surviving rows, on the clustered corpus
              and on the Gaussian one (the nothing-prunes overhead); the
              dense threshold scan against its plain version and a read of
              its surviving rows, and over every tile against torch.addmv;
              the compacted call (launch, sync, pairs to the host) against
              its plain version, over every tile, and
              batch_l2_squared_pruning end to end beside the path it
              replaced; the plan's kernel call against
              plan_threshold_survivors; the nearest-centroid pass at KC = 256 and
              16896 against its plain version (3 runs at 16896), with its
              shortlist sizes; the host time of cluster_reorder and of an
              IVFIndex build in scan-equivalents of K1's full f32 scan, the
              k-means++ seeding's host time apart, and of one
              IVFIndex.search_batch of 32 queries; the slot scans at Q = 16
              (table) and 1 (compare) on 3e's corpora and the hit-heavy
              ones, with the filter passes and table hits per (row, slot)
              by slot_table_plain's model (the kernel counts neither) and
              the shared memory of a CTA, and the sparse scan at Q = 1
              and 16 at the size of 3f, against their plain versions and
              same-bytes reads; the
              MaxSim scan at Q = 1 and B = 16 (f32) and B = 16 (bf16) at the
              size of 3g against its plain version and a read of the valid
              tokens' bytes, the host time of each public call, and the TPU
              record's small cell (1 x 32 tokens, 256 x 128 tokens, d=128).
              Every kernel's bound (the least time for its work: the bytes
              over 3.35 TB/s or its operations over the unit's peak, the
              larger; the packed scan's products on the b1 tensor cores at
              the rate scripts/packed_probe.py measured) is printed beside
              its time.

5. slice    — the repairs and the mutable serving path, each path with the
              launch counters reset just before it and read just after:
              a. ties: IVFIndex on integer-valued clustered 1M x 128 corpora
                 (1024 clusters; the layout permutes the rows, scores tie
                 exactly) equal to batch_knn* bit for bit in dot, l2 and
                 cosine at k = 1, 10, 256 and 259;
              b. long sparse queries: Lq = 8193 and 20,000 at Q = 1 and 16
                 (and 8193 at k = 256) over 3f's WordPiece corpus with
                 integer values, the kernel (its table in global memory
                 where one query's does not fit in shared memory) equal to
                 the plain version bit for bit, with ms, bound and launches;
              c. SegmentedCorpus: 10M x 128 f32 in 8 segments, 4% deleted,
                 knn_dot / knn / knn_cosine at Q = 32, k = 10 and 300 equal
                 to one batch_knn* scan of the alive rows bit for bit,
                 before and after compact(); search and compact ms, K1
                 launches per search, an npz round trip at 100K rows; then
                 10M x 100 unit rows in 8 segments, 4% deleted, with 24
                 near-copies of each of 32 queries planted (q + 3e-6 N(0,
                 1), renormalised; a quarter of them deleted): L2
                 distances clamp to 0.0, and knn / knn_dot / knn_cosine at
                 k = 10 and 100 equal batch_knn* over the alive rows bit
                 for bit, the clamp's ties in K1's key order included;
              d. MicroBatcher over the compacted corpus: direct QPS at b = 1,
                 8, 32, coalesced QPS of 96 single-query client threads,
                 every answer equal to a direct batched call bit for bit,
                 the batch histogram, the cost of padding 17 queries to 24;
                 one window through an IVFIndex;
              e. the host encoders (binary, ternary, u8 at 1M x 768; MinHash
                 of 100K documents) equal to the device encoders bit for
                 bit, host ms beside device ms.

6. sharded — innr_tpu_torch.parallel on meshes of one card: every container
              on [cuda:0] and on [cuda:0] x 4 (four shards scanned in turn
              on the same card), each path with the launch counters reset
              just before it and read just after, held to the single-card
              call over the same rows bit for bit:
              a. f32 10M x 128, Q=32, k=10: ShardedCorpus dot / l2 / cosine
                 / filtered and a (D,) query, QueryParallelIndex, GridIndex
                 2 x 2, HierarchicalCorpus 2 x 2, a MicroBatcher (16 client
                 threads) in front of the 4-shard corpus, and
                 corpus_from_process_local_rows on a one-rank NCCL group
                 (file rendezvous in a temporary directory);
                 sharded_overhead_1dev (one-card mesh against
                 batch_knn_dot) at 2M and 10M, the 4-shard call, the merge
                 alone;
              b. bf16 20M x 128 (dot, l2, cosine, filtered); prune=True on
                 the clustered 10M x 128 corpus over 4 shards (no K1
                 launch); ShardedQuantizedU8 1M x 768;
              c. ShardedPackedBinary 30M x 768 bits and ShardedPackedTernary
                 15M x 768 (Q=16); ShardedSlotCorpus 10M x 128 u32 and u16;
                 ShardedSparseCorpus 10M x 32 (Q=16);
              d. ShardedMaxSimCorpus 200K x 180 x 128 f32 (B=16);
                 ShardedTwoStageIndex 1M x 768 in the four coarse kinds (4
                 shards: against the single-card index over each shard's
                 rows, merged by score).
              Each family's 4-shard call is timed beside its single-card
              call (CUDA events, host copy included, median of 7).

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
# The pruning cells (3d): the clustered corpus's rows, and the IVFIndex
# clusters (8 x the 2112 tiles of the default tiling at 10M x 128).
N_PRUNE, IVF_CLUSTERS = 10_000_000, 16_896
# The MinHash cells (3e): sketches x slots; the sparse cells (3f):
# documents x entries, the WordPiece vocabulary, query entries.
N_SKETCH, SLOTS = 10_000_000, 128
N_SPARSE, ENTRIES, VOCAB, QUERY_NNZ = 10_000_000, 32, 30_522, 64
# The MaxSim cell (3g): ColBERTv2's published widths (stanford-futuredata/
# ColBERT, colbert/infra/config/settings.py: dim 128, query_maxlen 32,
# doc_maxlen 180) over 200K documents, a TREC-COVID-sized BEIR corpus.
N_MAXSIM, MAXSIM_TD, MAXSIM_D, MAXSIM_TQ = 200_000, 180, 128, 32
# The slice's cells (5): the ties corpus and its IVF clusters; the
# SegmentedCorpus (8 segments of 1.25M rows: 10M x 128); the host encoders'
# rows (x 768) and MinHash documents (x 64 shingles, 128 slots).
N_TIES, TIES_CLUSTERS = 1 << 20, 1024
N_SEGMENTS, SEGMENT_ROWS = 8, 1_250_000
N_LOADER, N_MINHASH_DOCS = 1_000_000, 100_000
# The sharded cells (6), from PERF.md section 4: f32 N_SHARDED x 128 (bf16
# twice the rows, binary 3x and ternary 1.5x the rows at 768 bits), the
# overhead cell of bench.py:228 (2M x 128), u8 and the two-stage index at
# N_SHARDED_U8 x 768.
N_SHARDED, N_OVERHEAD, N_SHARDED_U8 = 10_000_000, 2_000_000, 1_000_000

# Published peaks of one H100 SXM (NVIDIA's H100 datasheet): HBM at
# 3.35 TB/s, FP32 SIMT at 67 TFLOP/s, dense tensor cores at 989 TFLOP/s in
# bf16 and 495 in TF32. The
# integer and shared-memory rates follow the CUDA C++ Programming Guide's
# per-SM throughput for compute capability 9.0 at the clock the FP32 peak
# implies (256 FP32 flops per clock per SM on 132 SMs: 1.98 GHz): INT32
# add / compare 64 per clock per SM, popcount 16, shared-memory loads 32.
# NVIDIA publishes no b1 (1-bit AND + popcount) tensor-core rate for the
# H100: "b1" is the rate scripts/packed_probe.py measured on an H100 80GB
# HBM3 at 700 W, in bit products (m x n x k) per second: wgmma m64n128k256
# b1 7.81e15 (mma.sync m16n8k256, which the packed scan issues, 5.11e15).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12, "int32": 67e12 / 4,
                  "popc": 67e12 / 16, "shared": 67e12 / 8, "b1": 7.81e15}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, **ops: float) -> tuple:
    """``(ms, "bytes" or "operations")``: the least time the card could take
    for work that moves ``n_bytes`` (each input read once, each output
    written once) and does ``ops`` (unit -> count, e.g. ``fp32=2 Q N D``),
    the larger of the bytes over the memory rate and each count over its
    unit's peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max((n / PEAK_OPS_PER_S[unit] * 1e3 for unit, n in ops.items()), default=0.0)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_text(b: tuple) -> str:
    return f"bound {b[0]!r} ms ({b[1]})"


def _counted():
    """(kernel name, module, its total counter's name, counts by instance)."""
    from innr_tpu_torch.kernels import assign as ta
    from innr_tpu_torch.kernels import hamming as th
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import maxsim_kernel as tm
    from innr_tpu_torch.kernels import packed_knn as tp
    from innr_tpu_torch.kernels import pruned_knn as tpk
    from innr_tpu_torch.kernels import slot_knn as tsl
    from innr_tpu_torch.kernels import sparse_knn as tsp

    return (
        ("knn_scan+knn_merge", tk, "LAUNCHES", tk.LAUNCHES_BY_DTYPE),
        ("packed_scan", tp, "LAUNCHES", tp.LAUNCHES_BY_KIND),
        ("packed_rows", th, "LAUNCHES", th.LAUNCHES_BY_KIND),
        ("knn_scan_tiles+knn_merge", tpk, "LAUNCHES", tpk.LAUNCHES_BY_DTYPE),
        ("threshold_scan", tpk, "THRESHOLD_LAUNCHES", tpk.THRESHOLD_LAUNCHES_BY_FORM["dense"]),
        ("threshold_compact", tpk, "THRESHOLD_LAUNCHES",
         tpk.THRESHOLD_LAUNCHES_BY_FORM["compact"]),
        ("threshold_plan", tpk, "PLAN_LAUNCHES", None),  # one instance
        ("nearest_centroid", ta, "LAUNCHES", ta.LAUNCHES_BY_DTYPE),
        ("slot_scan", tsl, "LAUNCHES", tsl.LAUNCHES_BY_DTYPE),
        ("sparse_scan", tsp, "LAUNCHES", None),  # one instance
        ("maxsim_scores", tm, "LAUNCHES", tm.LAUNCHES_BY_DTYPE),
    )


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    for _, mod, total, by in _counted():
        setattr(mod, total, 0)
        for key in by or ():
            by[key] = 0


def read_counts() -> dict:
    """Launches per kernel instance, e.g. ``packed_scan<binary>``; a kernel
    with one instance under its own name."""
    counts = {}
    for name, mod, total, by in _counted():
        if by is None:
            counts[name] = getattr(mod, total)
        else:
            counts.update({f"{name}<{key}>": n for key, n in by.items()})
    return counts


def launches_of(counts: dict, name: str) -> int:
    """All launches of one kernel, over its instances."""
    return sum(n for key, n in counts.items() if key == name or key.startswith(f"{name}<"))


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
    modes = ("dot", "l2", "cosine", "dotm", "l2m", "cosinem")
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
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


def planes(gen, kind: str, shape, dev, overlap: bool = False) -> tuple:
    """One plane of random words (binary) or two ternary planes: disjoint,
    or with ``overlap`` drawn independently (a position may be in both, as
    raw planes can be; the kernel and the plain version score them alike)."""
    a = words(gen, shape, dev)
    if kind == "binary":
        return (a,)
    b = words(gen, shape, dev)
    return (a, b) if overlap else (a & b, a & ~b)


def phase_exact_packed(dev) -> int:
    import torch

    from innr_tpu_torch.kernels import hamming as th
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import packed_knn as tp

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cap = tk.single_pass_k(1)
    checks = 0

    def check(kind, rows_t, qs, k, what) -> None:
        expect_equal(f"exact packed_scan<{kind}> {what} k={k}",
                     tp.fused_packed_keys_batch(qs, rows_t, k),
                     tp.packed_knn_plain(qs, rows_t, k))

    # n % 4 == 1: the scan loads words one by one; n % 4 == 0: 16-byte loads.
    for n in (3 * 1024 + 77, 3 * 1024 + 76):
        for kind, overlap in (("binary", False), ("ternary", False), ("ternary", True)):
            for d in (1, 77, 288, 768, 2048):
                w = -(-d // 32)
                rows = planes(gen, kind, (n, w), dev, overlap)
                for p in rows:  # copies of row 5: ties must go to the lowest row
                    p[[100, 2000, n - 1]] = p[5].clone()
                    p[[7, 3000]] = 0   # all-zero rows
                    p[[11, 2999]] = -1  # all-ones rows (both planes: overlapping)
                rows_t = tuple(p.T.contiguous() for p in rows)
                for n_q in (1, 5, 16, 32, 33, 64):
                    qs = planes(gen, kind, (n_q, w), dev, overlap)
                    for q, p in zip(qs, rows):  # query 0 is row 5: its copies tie
                        q[0] = p[5]
                        if n_q > 2:
                            q[1] = -1  # an all-ones query
                    for k in (1, 10, cap, cap + 3):
                        check(f"{kind}{' overlap' if overlap else ''}", rows_t, qs, k,
                              f"n={n} d={d} q={n_q}")
                        checks += 1
                q1 = tuple(q[0] for q in planes(gen, kind, (1, w), dev, overlap))
                if not torch.equal(th.packed_rows(q1, rows), th.hamming_rows_plain(q1, rows)):
                    raise AssertionError(f"exact packed_rows<{kind}> d={d}: kernel != plain")
                checks += 1
    # Queries too wide to stay resident in shared memory: staged per item.
    n = 3 * 1024 + 76
    for kind, w in (("binary", 8000), ("ternary", 4000)):
        rows_t = tuple(p.T.contiguous() for p in planes(gen, kind, (n, w), dev, True))
        for n_q in (5, 64):
            tl = tp.tiling(n_q, w, 10, len(rows_t))
            if tl.resident:
                raise AssertionError(f"packed_scan<{kind}> W={w}: expected staged queries")
            qs = planes(gen, kind, (n_q, w), dev, True)
            for k in (10, cap + 3):
                check(kind, rows_t, qs, k, f"W={w} (staged queries) q={n_q}")
                checks += 1
        del rows_t
    torch.cuda.synchronize()
    log(f"[exact] {checks} packed kernel-vs-plain checks agree bit for bit")
    return checks


def bits_equal(a, b) -> bool:
    """Float tensors equal bit for bit, every NaN taken as the canonical one
    (GPU arithmetic and the plain version may carry other payloads)."""
    import torch

    def canon(x):
        return torch.where(torch.isnan(x), float("nan"), x).view(torch.int32)

    return torch.equal(canon(a), canon(b))


def _plans(gen, n_tiles: int, dev):
    """Survivor plans of every kind: no tile, one, all, a scattered set."""
    import torch

    from innr_tpu_torch.prune import _survivor_order

    one = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    one[n_tiles // 2] = True
    alive = {
        "none": torch.zeros(n_tiles, dtype=torch.bool, device=dev), "one": one,
        "all": torch.ones(n_tiles, dtype=torch.bool, device=dev),
        "scattered": torch.rand(n_tiles, generator=gen, device=dev) < 0.4,
    }
    return {name: _survivor_order(a, n_tiles) for name, a in alive.items()}


def phase_exact_pruned(dev) -> int:
    """The tile scan (K14), the threshold scan (K15) and the nearest-centroid
    pass (K13) against their plain versions, bit for bit on integer-valued
    data; the tile scan also against K1's full scan of the same rows."""
    import torch

    from innr_tpu_torch.kernels import assign as ta
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import pruned_knn as tpk

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cap = tk.single_pass_k(1)
    n = 3 * 1024 + 77
    checks = 0

    def corpus(n_rows, d, dtype):
        """Integer rows with planted duplicates of row 5 (ties go to the
        lowest row), and the aux of every mode."""
        rows = _int_corpus(gen, n_rows, d, dtype, dev)
        rows[[100, 2000, n_rows - 1]] = rows[5].clone()
        norms2, inv = tk._norms2(rows), tk.inv_norms(rows)
        mask = (torch.rand(n_rows, generator=gen, device=dev) < 0.5).float()
        return rows, {
            "dot": None, "l2": norms2, "cosine": inv, "dotm": mask,
            "l2m": torch.stack([norms2, mask]), "cosinem": torch.stack([inv, mask]),
        }

    def check(rows, aux_by_mode, tile_n, plans, queries, ks):
        nonlocal checks
        d = rows.shape[1]
        for plan, (order, n_surv) in _plans(gen, -(-rows.shape[0] // tile_n), dev).items():
            if plan not in plans:
                continue
            for n_q in queries:
                # Integer-valued queries in every mode (cosine too): each
                # score is then one rounding of an exact value.
                qs = torch.randint(-4, 5, (n_q, d), generator=gen, device=dev).float()
                qs[0] = rows[5].float()
                for mode, aux in aux_by_mode.items():
                    for k in ks:
                        name = (f"exact knn_scan_tiles {rows.dtype} n={rows.shape[0]} d={d} "
                                f"tile={tile_n} plan={plan} q={n_q} {mode} k={k}")
                        got = tpk.pruned_keys(qs, rows, aux, order, n_surv, tile_n, k, mode)
                        expect_equal(name, got, tpk.pruned_knn_plain(
                            qs, rows, aux, order, n_surv, tile_n, k, mode))
                        if plan == "all":
                            expect_equal(name + " vs K1", got, tk.fused_knn_keys_batch(
                                qs, rows, aux, k, mode))
                        checks += 1

    for dtype in (torch.float32, torch.bfloat16):
        for d in (127, 128):
            rows, aux_by_mode = corpus(n, d, dtype)
            for tile_n in (128, 200, 4736):
                check(rows, aux_by_mode, tile_n, ("none", "one", "all", "scattered"),
                      (1, 5, 32), (1, 10, cap + 3))
        # More chunks than one wave of CTAs: each CTA runs several items
        # through one load pipeline.
        rows, aux_by_mode = corpus(300_000 + 77, 128, dtype)
        for tile_n in (200, 4736):
            check(rows, aux_by_mode, tile_n, ("all", "scattered"), (32,), (10,))
    torch.cuda.synchronize()
    log(f"[exact] {checks} tile-scan checks agree bit for bit (with K1 on full plans)")

    k15 = compact = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 127, 128, 768):
            rows = _int_corpus(gen, n, d, dtype, dev)
            norms2 = tk._norms2(rows)
            q = torch.randint(-4, 5, (d,), generator=gen, device=dev).float()
            qq = (q * q).sum()
            for tile_n in (128, 200, 4736):
                for plan, (order, n_surv) in _plans(gen, -(-n // tile_n), dev).items():
                    got = tpk.threshold_dists(q, rows, norms2, order, n_surv, tile_n)
                    want = tpk.threshold_plain(q, rows, norms2, order, n_surv, tile_n)
                    if not bits_equal(got, want):
                        raise AssertionError(
                            f"exact threshold_scan {dtype} d={d} tile={tile_n} plan={plan}: "
                            "kernel != plain")
                    k15 += 1
                    compact += _exact_compact(
                        f"exact threshold_compact {dtype} d={d} tile={tile_n} plan={plan}",
                        q, rows, norms2, qq, order, n_surv, tile_n, got + qq, plan == "all")
    torch.cuda.synchronize()
    log(f"[exact] {k15} threshold-scan checks agree bit for bit; {compact} compacted-scan "
        "checks equal the dense kernel's rows within the threshold bit for bit (+inf on "
        "plans of every tile)")
    plans = _exact_plans(gen, dev)

    k13 = 0
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        for d in (7, 128, 300):
            if dtype == torch.uint8:
                rows = torch.randint(0, 256, (n, d), generator=gen, device=dev,
                                     dtype=torch.uint8)
            else:
                rows = torch.randint(-4, 5, (n, d), generator=gen, device=dev).float()
                rows[11] = float("nan")  # every score NaN: centroid 0
                rows = rows.to(dtype)
            for kc in (1, 3, 256, 2049, 16_896):
                # Small integer centroids keep every partial sum below 2^24:
                # exact in any summation order.
                cent = torch.randint(-4, 5, (kc, d), generator=gen, device=dev).float()
                if kc > 3:
                    cent[kc // 2] = cent[1]  # exact ties: the lower centroid wins
                got = ta.nearest_centroid(rows, cent)
                if not torch.equal(got, ta.nearest_centroid_plain(rows, cent)):
                    raise AssertionError(f"exact nearest_centroid {dtype} d={d} kc={kc}: "
                                         "kernel != plain")
                if dtype != torch.uint8 and int(got[11]) != 0:
                    raise AssertionError("nearest_centroid: a NaN row must get centroid 0")
                k13 += 1
    torch.cuda.synchronize()
    log(f"[exact] {k13} nearest-centroid checks agree exactly")
    k13 += _exact_tf32_near_ties(gen, n, dev)
    return checks + k15 + compact + plans + k13


def _exact_plans(gen, dev) -> int:
    """The threshold plan's kernel against ``plan_threshold_survivors``:
    order, n_surv and alive equal, for 1 to 16,896 tiles (one to 17 chunks
    of the kernel's CTA), 1 and 3 queries near a centroid, NaN radii, and
    thresholds from -inf through the bounds' spread to +inf and NaN."""
    import torch

    from innr_tpu_torch.kernels import pruned_knn as tpk
    from innr_tpu_torch.prune import plan_threshold_survivors

    checks = 0
    for n_tiles in (1, 1024, 1025, 2112, 16_896):
        cent = 3.0 * torch.randn((n_tiles, 128), generator=gen, device=dev)
        rad = torch.rand(n_tiles, generator=gen, device=dev) * 8
        if n_tiles > 1:
            rad[n_tiles // 3] = float("nan")
        for n_q in (1, 3):
            qs = cent[:1] + 0.5 * torch.randn((n_q, 128), generator=gen, device=dev)
            for thr in (-float("inf"), 0.0, 30.0, 1500.0, 2300.0, 3000.0, float("inf"),
                        float("nan")):
                got = tpk.threshold_plan(qs, cent, rad, thr)
                want = plan_threshold_survivors(qs, cent, rad, thr)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                        and torch.equal(got[2], want[2])):
                    raise AssertionError(f"exact threshold_plan tiles={n_tiles} q={n_q} "
                                         f"threshold={thr}: kernel != plain")
                checks += 1
    torch.cuda.synchronize()
    log(f"[exact] {checks} threshold-plan checks agree exactly (order, n_surv, alive)")
    return checks


def _dense_survivors(dense, threshold: float):
    """Today's keep-mask and ``nonzero`` over the dense distances (+ qq):
    ``(idx, dists)`` on the host."""
    import numpy as np
    import torch

    keep = ~(dense > float(np.float32(threshold))) & ~torch.isnan(dense)
    idx = torch.nonzero(keep).flatten()
    return idx.cpu(), dense[idx].cpu()


def _same_survivors(name: str, got, want) -> None:
    """Indices equal and distances equal bit for bit."""
    import torch

    if not (torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                         want[1].view(torch.int32))):
        raise AssertionError(f"{name}: {len(got[0])} pairs against {len(want[0])} of the dense "
                             "kernel with the keep-mask")


def _exact_compact(name: str, q, rows, norms2, qq, order, n_surv, tile_n, dense,
                   every_tile: bool) -> int:
    """The compacted scan at thresholds that keep nothing, one row, half
    and every finite live row, against the dense kernel's distances
    (``dense``, + qq) under today's keep-mask: bit for bit. At +inf the mask
    keeps the dead tiles' +inf rows too, and the planner then leaves no
    tile dead: +inf is checked on plans of every tile. Returns the checks
    made."""
    import torch

    from innr_tpu_torch.kernels import pruned_knn as tpk

    fin = dense[torch.isfinite(dense)]
    levels = [-1.0] + ([float("inf")] if every_tile else [])
    if fin.numel():
        levels += [float(fin.min()), float(fin.median()), float(fin.max())]
    for thr in levels:
        got = tpk.threshold_survivors(q, rows, norms2, qq, order, n_surv, tile_n, thr)
        _same_survivors(f"{name} threshold={thr!r}", got, _dense_survivors(dense, thr))
    return len(levels)


def _exact_tf32_near_ties(gen, n: int, dev) -> int:
    """The nearest-centroid kernel's tensor-core shortlist on exact
    arithmetic that TF32 cannot represent: integer rows in [-3, 3] ([0, 3]
    for u8) and centroids on the 2^-12 grid below 4 in magnitude, so every
    FP32 dot is exact in any order but the centroids round in TF32; in each
    group of three centroids two differ from the first by 1 or 2 units of
    2^-12 in one coordinate (near ties). Kernel equal to plain, f32, bf16
    and u8, D in {8, 128, 130}, KC in {1, 255, 256, 16896}."""
    import torch

    from innr_tpu_torch.kernels import assign as ta

    checks = 0
    for d in (8, 128, 130):
        for kc in (1, 255, 256, 16_896):
            grid = torch.randint(-16_383, 16_384, (kc, d), generator=gen, device=dev)
            grid = grid[torch.arange(kc, device=dev) // 3 * 3]
            step = torch.randint(1, 3, (kc,), generator=gen, device=dev)
            step = step * torch.where(torch.rand(kc, generator=gen, device=dev) < 0.5, -1, 1)
            step = step * (torch.arange(kc, device=dev) % 3 != 0)
            j = torch.randint(0, d, (kc,), generator=gen, device=dev)
            grid[torch.arange(kc, device=dev), j] += step
            cent = grid.clamp(-16_383, 16_383).float() / 4096.0
            for dtype in (torch.float32, torch.bfloat16, torch.uint8):
                lo = 0 if dtype == torch.uint8 else -3
                rows = torch.randint(lo, 4, (n, d), generator=gen, device=dev).to(dtype)
                got = ta.nearest_centroid(rows, cent)
                if not torch.equal(got, ta.nearest_centroid_plain(rows, cent)):
                    raise AssertionError(f"exact TF32 near ties nearest_centroid {dtype} d={d} "
                                         f"kc={kc}: kernel != plain")
                checks += 1
            rows_n, total, top = ta.shortlist_stats()
            log(f"[exact] TF32 near ties d={d} kc={kc} (u8 rows): shortlist mean "
                f"{total / rows_n!r}, largest {top} per row")
    torch.cuda.synchronize()
    log(f"[exact] {checks} nearest-centroid TF32 near-tie checks agree exactly")
    return checks


def phase_exact_tc(dev) -> int:
    """K1's tensor-core scan (full and tile scan) on exact arithmetic that
    its tensor-core products cannot represent, against the plain versions
    bit for bit. f32: rows of odd integers in [2049, 4095] (TF32 drops each
    one's low bit, which 3xTF32's x_lo restores) and integer queries in
    [-8, 8], so every FP32 dot is exact in any order but no TF32 product
    is; near ties planted (exact duplicates, rows with one coordinate the
    next odd integer); then queries with two nonzero dimensions of odd
    values 2049-2055 against rows of odd integers up to 4033, whose
    products 3xTF32 cannot represent either (it drops x_lo q_lo), every
    dot still exact in FP32. bf16: rows
    +-2^e (1 + j/16), e in [-2, 1], with the same duplicates and rows one
    bf16 ulp apart, so the products span 2^-9 to 2^5 and the tensor core's
    accumulation, not the products' rounding, separates near scores; every
    FP32 sum is still exact. u8: uniform codes, with codes below 16 in the
    first four dimensions, against integer queries in [-8, 8] that hold, in
    one or two of those dimensions, +-v with v odd in [2^17, 2^18): 18
    significant bits, which the hi/lo bf16 split cannot represent, while
    every FP32 dot stays an integer below 2^24, exact in any order; rows of
    codes 0 and 255, duplicates and rows one code apart planted. All six
    modes (integer queries in every mode, cosine too: each score is one
    rounding of an exact value), D in {1, 127, 128, 768}, Q in {1, 5, 32,
    67} (67: two query tiles of 64), k in {1, 10, cap + 3}; then 1M rows at
    D = 128 (u8: 768), Q in {1, 32}, k = 10, where the slabs are long
    enough for the gate to reject. Logs the re-scored pairs
    (``knn.rescore_stats``)."""
    import torch

    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import pruned_knn as tpk

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cap, tile_n = tk.single_pass_k(1), 200
    checks = 0

    def corpus(n, d, dtype):
        if dtype == torch.float32:
            rows = (2 * torch.randint(1024, 2048, (n, d), generator=gen, device=dev) + 1).float()
        elif dtype == torch.uint8:
            rows = torch.randint(0, 256, (n, d), generator=gen, device=dev, dtype=torch.uint8)
            rows[:, :4] %= 16
            rows[5], rows[6] = 0, 255
            rows[6, :4] = 15
        else:
            j = torch.randint(0, 16, (n, d), generator=gen, device=dev)
            e = torch.randint(-2, 2, (n, d), generator=gen, device=dev).float()
            sign = torch.where(torch.rand((n, d), generator=gen, device=dev) < 0.5, -1.0, 1.0)
            rows = (sign * (1 + j / 16) * torch.exp2(e)).to(torch.bfloat16)
        src = torch.randint(0, n // 2, (64,), generator=gen, device=dev)
        rows[n // 2:n // 2 + 32] = rows[src[:32]]
        near = rows[src[32:]].clone()
        if dtype == torch.float32:
            near[:, 0] += 2.0
        elif dtype == torch.uint8:
            top = 15 if d <= 4 else 255
            near[:, -1] = torch.where(near[:, -1] < top, near[:, -1] + 1, near[:, -1] - 1)
        else:
            near.view(torch.int16)[:, 0] += 1
        rows[n // 2 + 32:n // 2 + 64] = near
        norms2, inv = tk._norms2(rows), tk.inv_norms(rows)
        mask = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        return rows, {
            "dot": None, "l2": norms2, "cosine": inv, "dotm": mask,
            "l2m": torch.stack([norms2, mask]), "cosinem": torch.stack([inv, mask]),
        }

    def u8_queries(n_q, d):
        """Integers in [-8, 8], and +-v, v odd in [2^17, 2^18), in one or
        two of the first four dimensions (where the codes are below 16)."""
        qs = torch.randint(-8, 9, (n_q, d), generator=gen, device=dev).float()
        for _ in range(min(2, d)):
            col = torch.randint(0, min(4, d), (n_q,), generator=gen, device=dev)
            v = 2**17 + 1 + 2 * torch.randint(0, 2**16, (n_q,), generator=gen, device=dev)
            sign = torch.where(torch.rand(n_q, generator=gen, device=dev) < 0.5, -1, 1)
            qs[torch.arange(n_q, device=dev), col] = (sign * v).float()
        return qs

    def check(rows, aux_by_mode, queries, ks):
        nonlocal checks
        n, d = rows.shape
        order, n_surv = _plans(gen, -(-n // tile_n), dev)["scattered"]
        for n_q in queries:
            if rows.dtype == torch.uint8:
                qs = u8_queries(n_q, d)
            else:
                qs = torch.randint(-8, 9, (n_q, d), generator=gen, device=dev).float()
            for mode, aux in aux_by_mode.items():
                for k in ks:
                    name = f"exact TC near ties {rows.dtype} n={n} d={d} q={n_q} {mode} k={k}"
                    got = tk.fused_knn_keys_batch(qs, rows, aux, k, mode)
                    if mode == "dot" and k == 10:
                        rows_n, q_n, pairs = tk.rescore_stats()
                        log(f"[exact] {name}: re-scored {pairs} pairs, "
                            f"{pairs / q_n!r} per query ({rows_n} rows)")
                    expect_equal(name, got, tk.knn_plain(qs, rows, aux, k, mode))
                    got = tpk.pruned_keys(qs, rows, aux, order, n_surv, tile_n, k, mode)
                    expect_equal(name + " tiles", got, tpk.pruned_knn_plain(
                        qs, rows, aux, order, n_surv, tile_n, k, mode))
                    checks += 2

    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        for d in (1, 127, 128, 768):
            rows, aux_by_mode = corpus(3 * 1024 + 77, d, dtype)
            check(rows, aux_by_mode, (1, 5, 32, 67), (1, 10, cap + 3))
        rows, aux_by_mode = corpus(1_000_000, 768 if dtype == torch.uint8 else 128, dtype)
        check(rows, aux_by_mode, (1, 32), (10,))
        del rows, aux_by_mode
    for d in (1, 127, 128, 768):
        rows = (2 * torch.randint(1024, 2017, (3 * 1024 + 77, d), generator=gen, device=dev)
                + 1).float()
        rows[1000:1032] = rows[:32]
        norms2, inv = tk._norms2(rows), tk.inv_norms(rows)
        mask = (torch.rand(rows.shape[0], generator=gen, device=dev) < 0.5).float()
        aux_by_mode = {"dot": None, "l2": norms2, "cosine": inv, "dotm": mask,
                       "l2m": torch.stack([norms2, mask]), "cosinem": torch.stack([inv, mask])}
        for n_q in (5, 32):
            qs = torch.zeros((n_q, d), device=dev)
            for j in range(min(2, d)):
                col = torch.randint(0, d, (n_q,), generator=gen, device=dev)
                val = 2049 + 2 * torch.randint(0, 4, (n_q,), generator=gen, device=dev)
                sign = torch.where(torch.rand(n_q, generator=gen, device=dev) < 0.5, -1, 1)
                qs[torch.arange(n_q, device=dev), col] = (sign * val).float()
            for mode, aux in aux_by_mode.items():
                for k in (10, cap + 3):
                    name = f"exact 3xTF32 residue f32 d={d} q={n_q} {mode} k={k}"
                    expect_equal(name, tk.fused_knn_keys_batch(qs, rows, aux, k, mode),
                                 tk.knn_plain(qs, rows, aux, k, mode))
                    checks += 1
    torch.cuda.synchronize()
    log(f"[exact] {checks} tensor-core near-tie kNN checks (full and tile scan) agree bit "
        "for bit")
    return checks


def _plain_chunked(qs, rows, aux, k: int, mode: str, chunk: int = 64):
    """knn_plain over ``chunk`` queries at a time (its (Q, N) scores do not
    fit at many queries over a large corpus)."""
    import torch

    from innr_tpu_torch.kernels import knn as tk

    parts = [tk.knn_plain(qs[s:s + chunk], rows, aux, k, mode)
             for s in range(0, qs.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _scheduled(path: str, *args, **kwargs):
    """fused_knn_keys_batch with K1's planner held to ``path`` ("wide" or
    "tile"); every pass must have taken it."""
    from innr_tpu_torch.kernels import knn as tk

    planner, before = tk.scan_path, dict(tk.LAUNCHES_BY_PATH)
    tk.scan_path = lambda *a: path
    try:
        got = tk.fused_knn_keys_batch(*args, **kwargs)
    finally:
        tk.scan_path = planner
    other = "tile" if path == "wide" else "wide"
    if (tk.LAUNCHES_BY_PATH[path] == before[path]
            or tk.LAUNCHES_BY_PATH[other] != before[other]):
        raise AssertionError(f"{path} schedule not taken: {before} -> {tk.LAUNCHES_BY_PATH}")
    return got


def phase_exact_wide(dev) -> int:
    """K1's wide schedule on phase_exact_tc's exact inputs, against the plain
    version bit for bit: f32 rows of odd integers in [2049, 4095] with
    duplicates and rows one odd integer apart planted, integer queries in
    [-8, 8]; then queries with two nonzero dimensions of odd values
    2049-2055 (their 3xTF32 products drop x_lo q_lo) against odd integers up
    to 4033. D in {32, 64, 96}, Q in {256, 1000}, six modes, k in {1, 10,
    12} (12: the largest its layout takes at D = 96); then 10M rows at D =
    64 and 96 and Q = 10,000, k = 10, also against the tile schedule. Logs
    the re-scored pairs per query."""
    import torch

    from innr_tpu_torch.kernels import knn as tk

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    checks = 0

    def corpus(n, d, hi=2048):
        rows = (2 * torch.randint(1024, hi, (n, d), generator=gen, device=dev) + 1).float()
        src = torch.randint(0, n // 2, (64,), generator=gen, device=dev)
        rows[n // 2:n // 2 + 32] = rows[src[:32]]
        near = rows[src[32:]].clone()
        near[:, 0] += 2.0
        rows[n // 2 + 32:n // 2 + 64] = near
        norms2, inv = tk._norms2(rows), tk.inv_norms(rows)
        mask = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        return rows, {"dot": None, "l2": norms2, "cosine": inv, "dotm": mask,
                      "l2m": torch.stack([norms2, mask]), "cosinem": torch.stack([inv, mask])}

    def residue_queries(n_q, d):
        qs = torch.zeros((n_q, d), device=dev)
        for _ in range(2):
            col = torch.randint(0, d, (n_q,), generator=gen, device=dev)
            val = 2049 + 2 * torch.randint(0, 4, (n_q,), generator=gen, device=dev)
            sign = torch.where(torch.rand(n_q, generator=gen, device=dev) < 0.5, -1, 1)
            qs[torch.arange(n_q, device=dev), col] = (sign * val).float()
        return qs

    def check(name, qs, rows, aux, k, mode, tile=False):
        nonlocal checks
        got = _scheduled("wide", qs, rows, aux, k, mode)
        if mode == "dot" and k == 10:
            rows_n, q_n, pairs = tk.rescore_stats()
            log(f"[exact] {name}: re-scored {pairs} pairs, {pairs / q_n!r} per query "
                f"({rows_n} rows)")
        expect_equal(name, got, _plain_chunked(qs, rows, aux, k, mode))
        checks += 1
        if tile:
            expect_equal(name + " tile schedule", got, _scheduled("tile", qs, rows, aux, k, mode))
            checks += 1

    for d in (32, 64, 96):
        rows, aux_by_mode = corpus(3 * 1024 + 77, d)
        res_rows, res_aux = corpus(3 * 1024 + 77, d, hi=2017)
        for n_q in (256, 1000):
            qs = torch.randint(-8, 9, (n_q, d), generator=gen, device=dev).float()
            res_qs = residue_queries(n_q, d)
            for mode in aux_by_mode:
                for k in (1, 10, 12):
                    check(f"exact wide near ties d={d} q={n_q} {mode} k={k}",
                          qs, rows, aux_by_mode[mode], k, mode)
                    check(f"exact wide 3xTF32 residue d={d} q={n_q} {mode} k={k}",
                          res_qs, res_rows, res_aux[mode], k, mode)
        del rows, aux_by_mode, res_rows, res_aux
    for d in (64, 96):
        rows, aux_by_mode = corpus(10_000_000, d)
        qs = torch.randint(-8, 9, (10_000, d), generator=gen, device=dev).float()
        for mode in ("dot", "l2m"):
            check(f"exact wide near ties n=10M d={d} q=10000 {mode} k=10",
                  qs, rows, aux_by_mode[mode], 10, mode, tile=True)
        check(f"exact wide 3xTF32 residue n=10M d={d} q=10000 dot k=10",
              residue_queries(10_000, d), rows, None, 10, "dot", tile=True)
        del rows, aux_by_mode
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"[exact] {checks} wide-schedule kNN checks agree bit for bit")
    return checks


def unsigned_sort(x, dim: int):
    """Sort int32 views of uint32 values as unsigned: ``(values, order)``
    (a signed sort would put ids >= 2**31 and the sentinel first)."""
    import torch

    flip = torch.iinfo(torch.int32).min
    keys, order = torch.sort(x ^ flip, dim=dim, stable=True)
    return keys ^ flip, order


def sparse_rows(ids, vals):
    """Rows of (ids, values) sorted as unsigned, each repeated id (and the
    given sentinels, id -1 = 0xFFFFFFFF) made sentinel padding with value
    0.0 at the end of its row."""
    import torch

    ids, order = unsigned_sort(ids, 1)
    vals = torch.gather(vals, 1, order)
    rep = torch.zeros_like(ids, dtype=torch.bool)
    rep[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids, vals = torch.where(rep, -1, ids), torch.where(rep, 0.0, vals)
    ids, order = unsigned_sort(ids, 1)
    return ids, torch.gather(vals, 1, order)


def phase_exact_slot_sparse(dev) -> int:
    """The slot scan (K6/K7) and the sparse scan (K10) against their plain
    versions, bit for bit (counts, and integer-valued sparse scores, are
    exact in any summation order)."""
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import slot_knn as tsl
    from innr_tpu_torch.kernels import sparse_knn as tsp

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    cap = tk.single_pass_k(1)
    n = 3 * 1024 + 77
    k_slot, crossover = 0, tsl.COMPARE_MAX_TILE
    for dtype in (torch.int16, torch.int32):
        info = torch.iinfo(dtype)
        name = f"slot_scan<uint{info.bits}>"
        # Four slot values over the full width (the view's sign bit set in
        # the first), so that counts tie and nearly every table lookup hits;
        # and slots over the whole width, where lookups rarely hit.
        alphabet = torch.randint(info.min, info.max, (4,), generator=gen, device=dev, dtype=dtype)
        alphabet[0] = info.min
        for kind in ("four", "full"):
            def draw(shape):
                if kind == "four":
                    return alphabet[torch.randint(0, 4, shape, generator=gen, device=dev)]
                return _random_slots(gen, shape[0], shape[1], dtype, dev)

            for s in (1, 7, 128, 256):
                rows = draw((n + 3, s))
                rows[[100, 2000, n - 1]] = rows[5].clone()  # ties go to the lowest row
                # n + 3 rows: every slot row on a 16-byte boundary; n: most
                # off it (the compare scan's shifted vector pairs).
                for slots_t in (rows.T.contiguous(), rows[:n].T.contiguous()):
                    for n_q in (1, 2, 4, 16, 32, 33):
                        qs = draw((n_q, s))
                        qs[0] = rows[5]
                        if n_q > 1:  # query 1 shares query 0's value at every third slot
                            qs[1] = rows[9]
                            qs[1, ::3] = qs[0, ::3]
                        for k in (1, 10, cap + 3):
                            want = tsl.slot_knn_plain(qs, slots_t, k)
                            # Each scan at every Q: the crossover past
                            # every tile (compare), then below the first.
                            for mode, cut in (("compare", 32), ("table", 0)):
                                before = tsl.LAUNCHES_BY_MODE[mode]
                                tsl.COMPARE_MAX_TILE = cut
                                try:
                                    got = tsl.fused_slot_keys_batch(qs, slots_t, k)
                                finally:
                                    tsl.COMPARE_MAX_TILE = crossover
                                expect_equal(f"exact {name} {mode} {kind} n={slots_t.shape[1]} "
                                             f"s={s} q={n_q} k={k}", got, want)
                                if tsl.LAUNCHES_BY_MODE[mode] == before:
                                    raise AssertionError(f"{name}: mode {mode} did not launch")
                                k_slot += 1
        # A raw (N, S) corpus on the card is transposed per call and still
        # runs the kernel.
        slots_t = rows[:n].T.contiguous()
        before = tsl.LAUNCHES
        raw = itt.slot_knn_u16_batch if info.bits == 16 else itt.slot_knn_u32_batch
        counts, idx = raw(qs, rows[:n], 10)
        if tsl.LAUNCHES == before:
            raise AssertionError(f"{name}: a raw CUDA corpus did not launch the kernel")
        expect_equal(f"exact {name} raw corpus", (-counts, idx), tsl.slot_knn_plain(qs, slots_t, 10))
        # Wide sketches: no table tile fits, so 16 queries run the compare
        # scan (the plan's own choice), at N off and on 16-byte rows.
        rows = _random_slots(gen, n + 3, 2000, dtype, dev)
        rows[[100, n - 1]] = rows[5].clone()
        qs = _random_slots(gen, 16, 2000, dtype, dev)
        qs[0] = rows[5]
        for slots_t in (rows.T.contiguous(), rows[:n].T.contiguous()):
            for k in (1, 10):
                before = tsl.LAUNCHES_BY_MODE["compare"]
                expect_equal(f"exact {name} s=2000 n={slots_t.shape[1]} q=16 k={k}",
                             tsl.fused_slot_keys_batch(qs, slots_t, k),
                             tsl.slot_knn_plain(qs, slots_t, k))
                if tsl.LAUNCHES_BY_MODE["compare"] == before:
                    raise AssertionError(f"{name}: 2000 slots did not run the compare scan")
                k_slot += 1
    torch.cuda.synchronize()
    log(f"[exact] {k_slot} slot-scan checks (compare and table scans) agree bit for bit (and a "
        f"raw corpus per width)")

    # Ids over the full 32 bits (no sentinel among them), integer values:
    # every product and sum below is exact.
    vocab = torch.randint(-(2**31), 2**31, (512,), generator=gen, device=dev, dtype=torch.int32)
    vocab[vocab == -1] = 0
    k_sparse = 0
    for l in (1, 32, 200):
        ids = vocab[torch.randint(0, vocab.numel(), (n, l), generator=gen, device=dev)]
        nnz = torch.randint(0, l + 1, (n, 1), generator=gen, device=dev)
        ids = torch.where(torch.arange(l, device=dev) < nnz, ids, -1)  # sentinel padding
        ids[0] = -1  # an empty document
        vals = torch.randint(-4, 5, (n, l), generator=gen, device=dev).float()
        ids, vals = sparse_rows(ids, vals)
        for lq in (1, 64, 256, 300):
            for n_q in (1, 16):
                pick = torch.rand((n_q, vocab.numel()), generator=gen, device=dev).argsort(1)
                q_idx = unsigned_sort(vocab[pick[:, :lq]], 1)[0]
                q_val = torch.randint(-3, 4, (n_q, lq), generator=gen, device=dev).float()
                if lq > 1:
                    q_idx[:, 1] = q_idx[:, 0]  # a duplicate id: the first occurrence wins
                if n_q > 1:  # shorter queries padded with the sentinel
                    q_idx[1::2, lq // 2:], q_val[1::2, lq // 2:] = -1, 0.0
                # NaN, +-inf and -0.0 on an entry that query 0 matches and
                # on one that it does not.
                hit = q_idx[0, 0]
                miss = vocab[~torch.isin(vocab, q_idx[0])][0]
                for d, (i, v) in enumerate(((hit, float("nan")), (miss, float("nan")),
                                            (hit, float("inf")), (miss, -float("inf")),
                                            (hit, -0.0), (miss, float("inf"))), start=10):
                    ids[d], vals[d] = -1, 0.0
                    ids[d, 0], vals[d, 0] = i, v
                idx_t, val_t = ids.T.contiguous(), vals.T.contiguous()
                for k in (1, 10, cap + 3):
                    expect_equal(f"exact sparse_scan l={l} lq={lq} q={n_q} k={k}",
                                 tsp.fused_sparse_keys_batch(q_idx, q_val, idx_t, val_t, k),
                                 tsp.sparse_knn_plain(q_idx, q_val, idx_t, val_t, k))
                    k_sparse += 1
    k_union = _exact_sparse_union(gen, vocab, n, cap, dev)
    torch.cuda.synchronize()
    log(f"[exact] {k_sparse} sparse-scan checks agree bit for bit")
    return k_slot + k_sparse + k_union


def _exact_sparse_union(gen, vocab, n: int, cap: int, dev) -> int:
    """The sparse scan's one lookup per entry for a query tile, against the
    plain version bit for bit: queries drawn from 48 ids of the full 32
    bits (ids >= 2^31 among them), so the tile's queries share most ids,
    with duplicates inside a query (the first occurrence's value counts),
    sentinel padding of different lengths, and the sentinel as a corpus id;
    NaN, +inf and -inf corpus values on ids that query 0 holds and query 1
    does not; Q in {5, 13, 16} (not a multiple of the tile, and 16 at Lq =
    400, whose table does not fit one tile of 16), k in {10, cap + 3}."""
    import torch

    from innr_tpu_torch.kernels import sparse_knn as tsp

    shared = vocab[:48].clone()
    shared[:4] = torch.tensor([2**31 - 1, -(2**31), -2, 0], dtype=torch.int32, device=dev)
    l = 32
    ids = shared[torch.randint(0, 48, (n, l), generator=gen, device=dev)]
    nnz = torch.randint(0, l + 1, (n, 1), generator=gen, device=dev)
    ids = torch.where(torch.arange(l, device=dev) < nnz, ids, -1)
    vals = torch.randint(-4, 5, (n, l), generator=gen, device=dev).float()
    ids, vals = sparse_rows(ids, vals)
    checks = 0
    for lq, n_q in ((8, 5), (24, 13), (64, 16), (400, 16)):
        pool = shared if lq <= 48 else vocab
        pick = torch.rand((n_q, pool.numel()), generator=gen, device=dev).argsort(1)[:, :lq]
        q_idx = pool[pick]
        q_idx[:, 1] = q_idx[:, 0]  # a duplicate id: its first occurrence's value counts
        q_idx = unsigned_sort(q_idx, 1)[0]
        q_val = torch.randint(-3, 4, (n_q, lq), generator=gen, device=dev).float()
        q_idx[2::3, lq // 2:], q_val[2::3, lq // 2:] = -1, 0.0  # sentinel padding
        # Non-finite values on ids held by query 0 and not by query 1.
        only0 = [int(x) for x in q_idx[0, :lq // 2] if not bool((q_idx[1] == x).any())]
        for row, v in zip((20, 21, 22), (float("nan"), float("inf"), -float("inf"))):
            if only0:
                ids[row], vals[row] = -1, 0.0
                ids[row, 0], vals[row, 0] = only0[row % len(only0)], v
        idx_t, val_t = ids.T.contiguous(), vals.T.contiguous()
        tile, _ = tsp._table_tile(n_q, lq, 10)
        for k in (10, cap + 3):
            expect_equal(f"exact sparse_scan union lq={lq} q={n_q} (tile {tile}) k={k}",
                         tsp.fused_sparse_keys_batch(q_idx, q_val, idx_t, val_t, k),
                         tsp.sparse_knn_plain(q_idx, q_val, idx_t, val_t, k))
            checks += 1
    log(f"[exact] {checks} sparse-scan union-table checks agree bit for bit")
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


def _time_knn(rows, qs) -> tuple:
    """K1 (dot, k=10) on ``rows`` against its plain version and a same-bytes
    read: ``(kernel, plain, read)`` ms, and its bound; logs them with the
    share (bound / kernel), the read's fraction, the re-scored pairs and
    the query tile."""
    import torch

    from innr_tpu_torch.kernels import knn as tk

    kernel = _median_ms(lambda: tk.fused_knn_keys_batch(qs, rows, None, 10, "dot"))
    plain = _median_ms(lambda: tk.knn_plain(qs, rows, None, 10, "dot"))
    # The corpus bytes viewed as float32: a read at full bandwidth (a
    # uint8 sum accumulates in int64 and runs far slower than a read).
    read = _median_ms(lambda: rows.view(torch.float32).sum())
    (n, d), n_q = rows.shape, qs.shape[0]
    b, note = _knn_bound(rows, n_q, 10)
    log(f"[timing] {str(rows.dtype).removeprefix('torch.')} {n} x {d}, Q={n_q}, k=10: kernel "
        f"{kernel!r} ms, plain {plain!r} ms, same-bytes read {read!r} ms, share (bound/kernel) "
        f"{b[0] / kernel!r}, roofline fraction (read/kernel) {read / kernel!r}, "
        f"{bound_text(b)}{note}, query tile {tk._grid(rows, n_q, 10, tk.scan_path(rows, n_q, 10))[0]}")
    return (kernel, plain, read), b


def phase_timing(corpora: dict, bounds: dict) -> dict:
    import torch

    out = {}
    for name, rows, qs in (
        ("float32", corpora["f32"], corpora["qs128"]),
        ("bfloat16", corpora["bf16"], corpora["qs128"]),
        ("uint8", corpora["u8"], corpora["qs768"]),
    ):
        out[name], bounds[f"knn_scan+knn_merge<{name}>"] = _time_knn(rows, qs)
    # A single query (the query tile narrows to 8 columns), then u8 at 4M x
    # 768 (3.07 GB of uniform codes) at Q=32 and at Q=1 (batch_knn_u8's form).
    _time_knn(corpora["f32"], corpora["qs128"][:1].contiguous())
    _time_knn(corpora["u8"], corpora["qs768"][:1].contiguous())
    gen = torch.Generator(device=corpora["u8"].device).manual_seed(SEED + 11)
    big = torch.randint(0, 256, (4_000_000, 768), generator=gen, device=corpora["u8"].device,
                        dtype=torch.uint8)
    for n_q in (32, 1):
        _time_knn(big, corpora["qs768"][:n_q].contiguous())
    del big
    torch.cuda.empty_cache()
    return out


def phase_wide(dev) -> None:
    """K1 over 10M unit f32 rows (D = 96, 128), Q in {256, 1000, 10,000}, k
    = 10, dot: the planner's schedule's scores and indices within phase
    3a's tolerance of the plain version (64 queries at a time); where the
    wide schedule has a layout (D = 96), its keys bit for bit the tile
    schedule's; each schedule's kernel ms (median of 3) beside K1's bound
    (its re-scores: the planner's schedule's)."""
    import torch

    from innr_tpu_torch.kernels import knn as tk

    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    for d in (96, 128):
        rows = torch.randn((10_000_000, d), generator=gen, device=dev)
        rows /= torch.linalg.vector_norm(rows, dim=1, keepdim=True)
        for n_q in (256, 1000, 10_000):
            qs = torch.randn((n_q, d), generator=gen, device=dev)
            qs /= torch.linalg.vector_norm(qs, dim=1, keepdim=True)
            planned = tk.scan_path(rows, n_q, 10)
            name = f"K1 f32 unit rows 10M x {d}, Q={n_q}, dot, k=10 ({planned} schedule)"
            got = _scheduled(planned, qs, rows, None, 10, "dot")
            pk, pi = _plain_chunked(qs, rows, None, 11, "dot")
            err = check_close(name, scores_from_keys(got[0], "dot"), got[1],
                              scores_from_keys(pk, "dot"), pi,
                              _tol_dot(qs, rows, chunk=(1 << 30) // n_q))
            paths = ("tile", "wide") if tk._grid(rows, n_q, 10, "wide")[0] else ("tile",)
            if "wide" in paths:
                expect_equal(name + ": wide vs tile schedule", _scheduled("wide", qs, rows, None,
                                                                          10, "dot"),
                             _scheduled("tile", qs, rows, None, 10, "dot"))
            ms = {path: _median_ms(lambda p=path: _scheduled(p, qs, rows, None, 10, "dot"), 3)
                  for path in sorted(paths, key=lambda p: p == planned)}
            b, note = _knn_bound(rows, n_q, 10)  # the planner's schedule ran last
            log(f"[timing] {name}: kernel {ms!r} ms, {bound_text(b)}, share (bound/kernel) "
                f"{b[0] / ms[planned]!r}{note}; max score err vs plain {err!r}")
        del rows
        torch.cuda.empty_cache()


def _knn_bound(rows, n_q: int, k: int, read_rows: int | None = None) -> tuple:
    """K1's (or the tile scan's over ``read_rows``) bound after a launch on
    ``rows``, and a note of its re-scored pairs: the corpus (or surviving)
    bytes, the queries and the result, against the tensor-core products
    (f32: three TF32 products per pair and dimension, 3xTF32; bf16: one;
    u8: two bf16 products, the codes against the query's hi and lo parts)
    and the FP32 FMAs of the pairs the last launch re-scored."""
    import torch

    from innr_tpu_torch.kernels import knn as tk

    n, d = rows.shape
    read_rows = n if read_rows is None else read_rows
    unit, parts = {torch.float32: ("tf32", 3), torch.bfloat16: ("bf16", 1),
                   torch.uint8: ("bf16", 2)}[rows.dtype]
    _, _, pairs = tk.rescore_stats()
    ops = {unit: parts * 2 * n_q * read_rows * d, "fp32": 2 * d * pairs}
    note = f", re-scored {pairs} pairs ({pairs / n_q!r} per query)"
    n_bytes = read_rows * d * rows.element_size() + n_q * d * 4 + n_q * k * 8
    return bound(n_bytes, **ops), note


def _plan(vb, qs, k: int, mode: str):
    """The survivor plan ``prune=True`` makes for ``qs`` (unit queries for
    cosine) on ``vb``: ``(order, n_surv, summary)``."""
    from innr_tpu_torch.kernels import pruned_knn as tpk

    s = vb.tile_summary(normalized=mode == "cosine")
    return (*tpk.plan(qs, vb.rows, s, k, mode), s)


def _hold_to_plain(name: str, res, qs, vb, k: int, metric: str) -> float:
    """A ``batch_knn_dot`` / ``batch_knn`` / ``batch_knn_cosine`` result on
    ``vb`` against ``knn_plain`` over all its rows, under phase 3a's
    tolerances. Returns the max abs score difference."""
    import torch

    from innr_tpu_torch.kernels import knn as tk

    rows, dev = vb.rows, qs.device
    got = (torch.as_tensor(res.scores, device=dev), torch.as_tensor(res.indices, device=dev))
    if metric == "cosine":
        pv, pi = _plain_vals(tk._unit_queries(qs), rows, vb.inv_norms(), k + 1, "cosine")
        tol = torch.full((qs.shape[0], 1), 1e-5, dtype=torch.float64, device=dev)
        return check_close(name, *got, pv, pi, tol)
    q = qs.to(torch.bfloat16).float() if rows.dtype == torch.bfloat16 else qs
    tol = _tol_dot(q, rows)
    if metric == "dot":
        return check_close(name, *got, *_plain_vals(qs, rows, None, k + 1, "dot"), tol)
    norms2 = vb.norms2()
    pv, pi = _plain_vals(qs, rows, norms2, k + 1, "l2")
    qq = (qs * qs).sum(dim=1, keepdim=True).double()
    tol = 32 * EPS32 * (norms2.max().double() + qq) + 2 * tol
    return check_close(name, *got, (pv.double() + qq).clamp_min(0.0), pi, tol)


def _same_result(name: str, got, want) -> None:
    """Two BatchKnnResults equal: indices, and scores bit for bit."""
    import numpy as np

    if not (np.array_equal(got.indices, want.indices)
            and np.array_equal(got.scores.view(np.int32), want.scores.view(np.int32))):
        raise AssertionError(f"{name}: result differs from the full scan's")


def phase_gaussian_prune(dev, corpora: dict, full_ms: float) -> tuple[dict, tuple]:
    """prune=True on the Gaussian 10M x 128 corpus of phase 3a, where
    nothing prunes: the result equals the full scan's, and the overhead of
    the tile scan reading its plan (about every tile) over K1's full scan
    (``full_ms``, phase 4). Returns the path's launches and
    (pruned ms end to end, tile kernel ms, tiles read, tiles)."""
    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import pruned_knn as tpk

    rows, qs = corpora["f32"], corpora["qs128"]
    vb = itt.VerticalBatch(rows)
    full = itt.batch_knn_dot(qs, vb, 10)
    vb.tile_summary()
    reset_counts()
    pruned = itt.batch_knn_dot(qs, vb, 10, prune=True)
    launches = read_counts()
    _check_path("prune=True (Gaussian)", launches, ["knn_scan_tiles+knn_merge<float32>"])
    if launches_of(launches, "knn_scan+knn_merge"):
        raise AssertionError("prune=True launched K1's full scan")
    _same_result("batch_knn_dot prune=True, Gaussian", pruned, full)
    order, n_surv, s = _plan(vb, qs, 10, "dot")
    e2e = _median_ms(lambda: tpk.fused_knn_dot_pruned_batch(qs, rows, s, 10))
    kernel = _median_ms(lambda: tpk.pruned_keys(qs, rows, None, order, n_surv, s.tile_n, 10,
                                                "dot"))
    read_tiles = int(n_surv)
    log(f"[timing] nothing prunes (Gaussian {rows.shape[0]} x 128, Q={qs.shape[0]}, k=10, "
        f"tile {s.tile_n}): "
        f"{read_tiles} of {s.n_tiles} tiles read; prune=True end to end {e2e!r} ms, tile "
        f"kernel {kernel!r} ms, K1 full scan {full_ms!r} ms: overhead "
        f"{e2e / full_ms - 1.0!r} end to end, {kernel / full_ms - 1.0!r} kernel")
    return launches, (e2e, kernel, read_tiles, s.n_tiles)


def _clustered(gen, n: int, n_centers: int, ordered: bool, dev, sigma: float = 0.05):
    """The JAX bench's clustered corpus (``bench.py:452-496``): centres
    3 N(0, 1), rows centre + sigma N(0, 1), sorted by cluster or not, made on
    the device in chunks. Returns ``(rows, centres)``."""
    import torch

    centers = 3.0 * torch.randn((n_centers, 128), generator=gen, device=dev)
    assign = torch.randint(0, n_centers, (n,), generator=gen, device=dev)
    if ordered:
        assign = torch.sort(assign).values
    rows = torch.empty((n, 128), device=dev)
    for s in range(0, n, 1 << 20):
        e = min(n, s + (1 << 20))
        rows[s:e] = centers[assign[s:e]] + sigma * torch.randn((e - s, 128), generator=gen,
                                                               device=dev)
    return rows, centers


def _scan_equivalents(ms: float, full_ms: float) -> str:
    return f"{ms!r} ms = {ms / full_ms!r} scan-equivalents"


def _l2_tol(rows, q):
    """K1's tolerance of an L2^2 score (per row), in float64 on the rows'
    device."""
    r = rows.double()
    qd = q.double()
    return (32 * EPS32 * ((r * r).sum(1) + float((qd * qd).sum()))
            + 64 * EPS32 * (r.abs() @ qd.abs()))


def _survivors_close(name: str, got, want, rows, q, thr: float) -> float:
    """A compacted result against its plain version: the distances of rows
    both keep within K1's tolerance, a row that only one keeps within
    tolerance of the threshold. Returns the largest difference."""
    import torch

    gi, gd, wi, wd = (t.cpu() for t in (*got, *want))
    union = torch.unique(torch.cat([gi, wi]))
    tol = _l2_tol(rows[union.to(rows.device)], q).cpu()
    kept, dist = [], []
    for idx, d in ((gi, gd), (wi, wd)):
        at = torch.searchsorted(union, idx)
        k = torch.zeros(len(union), dtype=torch.bool)
        k[at] = True
        v = torch.full((len(union),), float("nan"), dtype=torch.float64)
        v[at] = d.double()
        kept.append(k)
        dist.append(v)
    both, one = kept[0] & kept[1], kept[0] ^ kept[1]
    diff = (dist[0] - dist[1]).abs()[both]
    edge = (torch.where(kept[0], dist[0], dist[1]) - thr).abs()[one]
    if bool((diff > tol[both]).any()) or bool((edge > tol[one]).any()):
        raise AssertionError(f"{name}: kernel and plain differ beyond rounding")
    return float(diff.max()) if bool(both.any()) else 0.0


def _pruning_against_plain(name: str, idx, dists, rows, q, thr: float) -> None:
    """``batch_l2_squared_pruning``'s rows and distances against a plain
    full pass in float64 over ``rows`` (f32 or bf16, widened), within K1's
    tolerance: every row clearly within the threshold is kept, no row
    clearly beyond it, each distance within tolerance."""
    import torch

    n = rows.shape[0]
    plain = torch.empty(n, dtype=torch.float64, device=rows.device)
    tol = torch.empty(n, dtype=torch.float64, device=rows.device)
    for a in range(0, n, 1 << 21):
        r = rows[a:a + (1 << 21)].double()
        plain[a:a + (1 << 21)] = ((r - q.double()) ** 2).sum(1)
        tol[a:a + (1 << 21)] = _l2_tol(rows[a:a + (1 << 21)], q)
    sure = set(torch.nonzero(plain <= thr - tol).flatten().cpu().tolist())
    maybe = set(torch.nonzero(plain <= thr + tol).flatten().cpu().tolist())
    if not sure <= set(idx.tolist()) <= maybe:
        raise AssertionError(f"{name}: survivor set != the plain full pass's")
    at = torch.as_tensor(idx, device=rows.device)
    diff = (torch.as_tensor(dists, device=rows.device).double() - plain[at]).abs()
    if bool((diff > tol[at]).any()):
        raise AssertionError(f"{name}: a distance is off the plain pass's")


def phase_prune(dev, full_ms: float, errs: dict, bounds: dict,
                library: dict) -> tuple[dict, dict]:
    """3d and its timing: prune=True, batch_knn_adaptive,
    batch_l2_squared_pruning, cluster_reorder and IVFIndex at 10M x 128,
    each path with the counters reset just before it and read just after.
    ``full_ms``: K1's full f32 scan (phase 4), the unit of the build costs.
    Returns the paths' launches and each new kernel's (ms, plain ms); puts
    the threshold scan's torch.addmv over every tile in ``library``."""
    import numpy as np
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import assign as ta
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.kernels import pruned_knn as tpk
    from innr_tpu_torch.prune import SEED_CHUNK, kmeanspp_seed, plan_threshold_survivors

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, n_q, k = N_PRUNE, 32, 10
    rows, centers = _clustered(gen, n, 256, True, dev)
    qs = centers[:n_q] + 0.01 * torch.randn((n_q, 128), generator=gen, device=dev)
    vb = itt.VerticalBatch(rows)
    vb16 = itt.VerticalBatch(rows, dtype=torch.bfloat16)
    funcs = (("batch_knn_dot", itt.batch_knn_dot), ("batch_knn", itt.batch_knn),
             ("batch_knn_cosine", itt.batch_knn_cosine))
    full = {(name, b): fn(qs, batch, k) for name, fn in funcs
            for b, batch in (("f32", vb), ("bf16", vb16))}
    for batch in (vb, vb16):
        batch.tile_summary(), batch.tile_summary(normalized=True)
    torch.cuda.synchronize()
    total = {}

    def path(name: str, must: list, run):
        return _run_path(name, must, run, total)

    for b, batch in (("f32", vb), ("bf16", vb16)):
        kernel = f"knn_scan_tiles+knn_merge<{'float32' if b == 'f32' else 'bfloat16'}>"
        res, counts = path(f"prune=True {b}", [kernel],
                           lambda: {name: fn(qs, batch, k, prune=True) for name, fn in funcs})
        if launches_of(counts, "knn_scan+knn_merge"):
            raise AssertionError(f"prune=True {b} launched K1's full scan")
        for (name, _), metric in zip(funcs, ("dot", "l2", "cosine")):
            _same_result(f"{name} prune=True {b} clustered", res[name], full[(name, b)])
            _hold_to_plain(f"{name} prune=True {b} clustered", res[name], qs, batch, k, metric)
            unit = tk._unit_queries(qs) if metric == "cosine" else qs
            _, n_surv, s = _plan(batch, unit, k, metric)
            log(f"[main] clustered {n} x 128 {b} {name}: {int(n_surv)} of {s.n_tiles} tiles "
                f"of {s.tile_n} rows read")
    log(f"[main] prune=True (batch_knn_dot, batch_knn, batch_knn_cosine; f32 and bf16; {n_q} "
        f"queries, k={k}) on the clustered {n} x 128 corpus equals the full scan bit for bit, "
        "with no K1 launch, and agrees with the plain full pass")

    res, _ = path("batch_knn_adaptive", ["knn_scan_tiles+knn_merge<float32>"],
                  lambda: itt.batch_knn_adaptive(qs, vb, k, 32))
    _same_result("batch_knn_adaptive", res, itt.batch_knn(qs, vb, k))
    log("[main] batch_knn_adaptive equals batch_knn (exact)")

    q0, thr = qs[0], 1.0
    norms2 = vb.norms2()
    for b, batch in (("f32", vb), ("bf16", vb16)):
        kernel = f"threshold_compact<{'float32' if b == 'f32' else 'bfloat16'}>"
        (idx, dists), counts = path(f"batch_l2_squared_pruning {b}", [kernel, "threshold_plan"],
                                    lambda: itt.batch_l2_squared_pruning(q0, batch, thr))
        if launches_of(counts, "threshold_scan"):
            raise AssertionError("batch_l2_squared_pruning launched the dense threshold scan")
        _pruning_against_plain(f"batch_l2_squared_pruning {b}", idx, dists, batch.rows, q0, thr)
    t_order, t_surv, t_alive = plan_threshold_survivors(
        q0[None], vb.tile_summary().centroids, vb.tile_summary().radii, thr)
    log(f"[main] batch_l2_squared_pruning (threshold {thr}, f32 and bf16): {len(idx)} rows "
        f"(bf16), equal to the plain full pass within K1's tolerance; {int(t_surv)} of "
        f"{vb.tile_summary().n_tiles} tiles read, one plan and one compacting launch, no "
        "dense one")
    got_plan = tpk.threshold_plan(q0[None], vb.tile_summary().centroids,
                                  vb.tile_summary().radii, thr)
    if not all(torch.equal(a, b) for a, b in zip(got_plan, (t_order, t_surv, t_alive))):
        raise AssertionError("threshold_plan: the cell's plan != plan_threshold_survivors'")
    # The compacted form bit for bit against the dense kernel and today's
    # keep-mask, at the cell's threshold and at one that keeps every row.
    s_all = vb.tile_summary()
    every = torch.arange(s_all.n_tiles, dtype=torch.int32, device=dev)
    all_n = torch.full((1,), s_all.n_tiles, dtype=torch.int32, device=dev)
    qq0 = (q0 * q0).sum()
    for name, order_, n_surv_, level in (("the cell's plan", t_order, t_surv, thr),
                                         ("every tile", every, all_n, float("inf"))):
        dense = tpk.threshold_dists(q0, rows, norms2, order_, n_surv_, s_all.tile_n) + qq0
        got = tpk.threshold_survivors(q0, rows, norms2, qq0, order_, n_surv_, s_all.tile_n,
                                      level)
        _same_survivors(f"threshold_compact clustered, {name}, threshold {level}", got,
                        _dense_survivors(dense, level))
        log(f"[main] threshold_compact, clustered {n} x 128 f32, {name}, threshold {level}: "
            f"{len(got[0])} rows, bit for bit the dense kernel's with the keep-mask")
    if len(got[0]) != n:
        raise AssertionError("threshold_compact: an infinite threshold must keep every row")
    del dense, got

    times = {}
    order, n_surv, s = _plan(vb, qs, k, "dot")
    surv_rows = min(n, int(n_surv) * s.tile_n)
    got = tpk.pruned_keys(qs, rows, None, order, n_surv, s.tile_n, k, "dot")
    want = tpk.pruned_knn_plain(qs, rows, None, order, n_surv, s.tile_n, k + 1, "dot")
    errs["knn_scan_tiles+knn_merge"] = check_close(
        "knn_scan_tiles clustered", scores_from_keys(got[0], "dot"), got[1],
        scores_from_keys(want[0], "dot"), want[1], _tol_dot(qs, rows))
    kernel = _median_ms(lambda: tpk.pruned_keys(qs, rows, None, order, n_surv, s.tile_n, k,
                                                "dot"))
    e2e = _median_ms(lambda: tpk.fused_knn_dot_pruned_batch(qs, rows, s, k))
    plain_ms = _median_ms(lambda: tpk.pruned_knn_plain(qs, rows, None, order, n_surv, s.tile_n,
                                                       k, "dot"))
    read_all = _median_ms(lambda: rows.sum())
    read_surv = _median_ms(lambda: rows[:surv_rows].sum())
    times["knn_scan_tiles+knn_merge"] = (kernel, plain_ms)
    # The surviving rows read once (the work this plan needs), the plan and
    # the queries read, the (Q, k) result written.
    # The surviving rows read once (the work this plan needs), the queries
    # read, the (Q, k) result written.
    bounds["knn_scan_tiles+knn_merge"], note = _knn_bound(rows, n_q, k, surv_rows)
    log(f"[timing] pruned scan, clustered {n} x 128 f32, Q={n_q}, k={k}: {int(n_surv)} of "
        f"{s.n_tiles} tiles ({surv_rows} rows) read; tile kernel {kernel!r} ms, prune=True "
        f"end to end {e2e!r} ms, plain {plain_ms!r} ms, K1 full scan {full_ms!r} ms "
        f"(speedup {full_ms / e2e!r} end to end), read of all rows {read_all!r} ms, of the "
        f"surviving rows {read_surv!r} ms, "
        f"{bound_text(bounds['knn_scan_tiles+knn_merge'])}{note}")

    t_surv_rows = min(n, int(t_surv) * s.tile_n)
    got = tpk.threshold_dists(q0, rows, norms2, t_order, t_surv, s.tile_n)
    want = tpk.threshold_plain(q0, rows, norms2, t_order, t_surv, s.tile_n)
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError("threshold_scan: kernel and plain differ in finite rows")
    errs["threshold_scan"] = float((got[fin] - want[fin]).abs().max())
    kernel = _median_ms(lambda: tpk.threshold_dists(q0, rows, norms2, t_order, t_surv,
                                                    s.tile_n))
    plain_ms = _median_ms(lambda: tpk.threshold_plain(q0, rows, norms2, t_order, t_surv,
                                                      s.tile_n))
    read_t = _median_ms(lambda: rows[:t_surv_rows].sum())
    kernel_all = _median_ms(lambda: tpk.threshold_dists(q0, rows, norms2, every, all_n,
                                                        s.tile_n))
    # Over every tile the scan is norms2 - 2 rows.q, one torch.addmv.
    addmv_all = _median_ms(lambda: torch.addmv(norms2, rows, q0, alpha=-2.0))
    times["threshold_scan"] = (kernel, plain_ms)
    library["threshold_scan"] = addmv_all

    def threshold_bound(read_rows, written):
        """The rows read and their norms, the query, ``written`` bytes."""
        return bound(4 * (read_rows * 129 + 128) + written, fp32=2 * 128 * read_rows)

    bounds["threshold_scan"] = threshold_bound(t_surv_rows, 4 * n)
    log(f"[timing] threshold scan (dense), clustered {n} x 128 f32, threshold {thr}: "
        f"{int(t_surv)} tiles ({t_surv_rows} rows); kernel {kernel!r} ms, plain {plain_ms!r} "
        f"ms, read of the surviving rows {read_t!r} ms, {bound_text(bounds['threshold_scan'])} "
        f"(share {bounds['threshold_scan'][0] / kernel!r}); every tile: kernel {kernel_all!r} "
        f"ms, read {read_all!r} ms (read/kernel {read_all / kernel_all!r}), torch.addmv "
        f"{addmv_all!r} ms, {bound_text(threshold_bound(n, 4 * n))}")

    # The compacted form: the call as batch_l2_squared_pruning makes it
    # (launch, the one synchronisation, the M pairs to the host).
    got = tpk.threshold_survivors(q0, rows, norms2, qq0, t_order, t_surv, s.tile_n, thr)
    want = tpk.threshold_survivors_plain(q0, rows, norms2, qq0, t_order, t_surv, s.tile_n, thr)
    errs["threshold_compact"] = _survivors_close("threshold_compact clustered", got, want, rows,
                                                 q0, thr)
    m = len(got[0])
    compact = _median_ms(lambda: tpk.threshold_survivors(q0, rows, norms2, qq0, t_order, t_surv,
                                                         s.tile_n, thr))
    compact_plain = _median_ms(lambda: tpk.threshold_survivors_plain(
        q0, rows, norms2, qq0, t_order, t_surv, s.tile_n, thr))
    call = _median_ms(lambda: itt.batch_l2_squared_pruning(q0, vb, thr))
    # What the call did before this design, on today's dense kernel: the
    # plain plan, the dense scan, + qq, the keep-mask, nonzero and the two
    # host copies.
    def dense_path():
        o, ns, _ = plan_threshold_survivors(q0[None], s.centroids, s.radii, thr)
        return _dense_survivors(tpk.threshold_dists(q0, rows, norms2, o, ns, s.tile_n)
                                + (q0 * q0).sum(), thr)

    dense_path_ms = _median_ms(dense_path)
    compact_all = _median_ms(lambda: tpk.threshold_survivors(q0, rows, norms2, qq0, every, all_n,
                                                             s.tile_n, thr))
    plan_k = _median_ms(lambda: tpk.threshold_plan(q0[None], s.centroids, s.radii, thr))
    plan_p = _median_ms(lambda: plan_threshold_survivors(q0[None], s.centroids, s.radii, thr))
    times["threshold_plan"] = (plan_k, plan_p)
    library["threshold_plan"] = None
    errs["threshold_plan"] = 0.0  # order, n_surv and alive equal (checked above)
    # The plan's function: centroids, radii and the query read, order,
    # alive and n_surv written; 2 T D FP32 operations for q . c.
    t_n = s.n_tiles
    bounds["threshold_plan"] = bound(4 * (t_n * 128 + t_n + 128) + 5 * t_n + 4,
                                     fp32=2 * t_n * 128)
    log(f"[timing] threshold plan, {t_n} tiles: the call (product, sums, one plan launch) "
        f"{plan_k!r} ms, plan_threshold_survivors {plan_p!r} ms, "
        f"{bound_text(bounds['threshold_plan'])}")
    times["threshold_compact"] = (compact, compact_plain)
    library["threshold_compact"] = None
    bounds["threshold_compact"] = threshold_bound(t_surv_rows, 8 * m)
    log(f"[timing] threshold scan (compacted), the same cell: {m} rows kept; the call "
        f"(launch, sync, pairs to the host) {compact!r} ms, plain {compact_plain!r} ms, "
        f"{bound_text(bounds['threshold_compact'])} (share "
        f"{bounds['threshold_compact'][0] / compact!r}); every tile {compact_all!r} ms; "
        f"batch_l2_squared_pruning end to end {call!r} ms (the plain plan and the dense "
        f"path with mask, nonzero and copies: {dense_path_ms!r} ms)")
    del got, want

    cent256 = centers + 0.1 * torch.randn(centers.shape, generator=gen, device=dev)
    errs["nearest_centroid"] = _assign_check(
        f"nearest_centroid {n} x 128, KC=256", rows, cent256, ta.nearest_centroid(rows, cent256),
        ta.nearest_centroid_plain(rows, cent256))
    shortlist = _shortlist_log(f"nearest_centroid {n} x 128, KC=256")
    kernel = _median_ms(lambda: ta.nearest_centroid(rows, cent256))
    plain_ms = _median_ms(lambda: ta.nearest_centroid_plain(rows, cent256))
    times["nearest_centroid"] = (kernel, plain_ms)

    def assign_bound(kc, pairs):
        """Rows, centroids and the result moved once; 2 N KC D TF32
        tensor-core operations and the re-scored pairs' 2 D FP32 FMA
        operations (this run's shortlist), each over its own unit's peak.
        The FP32-only figure of the SIMT design it replaced is logged beside
        it."""
        moved = 4 * (n * 128 + kc * 128 + n)
        log(f"[timing] nearest_centroid KC={kc}: the FP32-only bound of the earlier SIMT kernel "
            f"{bound_text(bound(moved, fp32=2 * n * kc * 128))}")
        return bound(moved, tf32=2 * n * kc * 128, fp32=2 * 128 * pairs)

    bounds["nearest_centroid"] = assign_bound(256, shortlist)
    log(f"[timing] nearest_centroid {n} x 128, KC=256: kernel {kernel!r} ms, plain "
        f"{plain_ms!r} ms, {bound_text(bounds['nearest_centroid'])}")
    del vb, vb16, rows, full, norms2
    torch.cuda.empty_cache()

    rows, centers = _clustered(gen, n, 256, False, dev)
    qs = centers[:n_q] + 0.01 * torch.randn((n_q, 128), generator=gen, device=dev)
    vb = itt.VerticalBatch(rows)
    full = itt.batch_knn(qs, vb, k)
    (nb, perm), _ = path("cluster_reorder", ["nearest_centroid<float32>"],
                         lambda: vb.cluster_reorder(n_clusters=256))
    p = perm.long()
    if not torch.equal(torch.sort(p).values, torch.arange(n, device=dev)):
        raise AssertionError("cluster_reorder: perm is not a permutation")
    for s0 in range(0, n, 1 << 20):
        if not torch.equal(rows[p[s0:s0 + (1 << 20)]], nb.rows[s0:s0 + (1 << 20)]):
            raise AssertionError("cluster_reorder: rows[perm] != the reordered rows")
    res, _ = path("prune=True on the reordered batch", ["knn_scan_tiles+knn_merge<float32>"],
                  lambda: itt.batch_knn(qs, nb, k, prune=True))
    mapped = p.cpu().numpy()[res.indices]
    if not (np.array_equal(mapped, full.indices)
            and np.array_equal(res.scores.view(np.int32), full.scores.view(np.int32))):
        raise AssertionError("prune=True on the reordered batch != the full scan")
    _, n_surv, s = _plan(nb, qs, k, "l2")
    reorder_ms = _median_host_ms(lambda: (vb.cluster_reorder(n_clusters=256),
                                          torch.cuda.synchronize()), reps=3)
    log(f"[main] cluster_reorder ({n} x 128, 256 clusters): perm is a permutation, rows[perm] "
        f"equal the reordered rows, prune=True on them maps back to the full scan's result; "
        f"tile {s.tile_n}, {int(n_surv)} of {s.n_tiles} tiles read")
    log(f"[timing] cluster_reorder host time {_scan_equivalents(reorder_ms, full_ms)}")
    del vb, nb, perm, p, rows
    torch.cuda.empty_cache()

    n_clusters = IVF_CLUSTERS
    rows, centers = _clustered(gen, n, n_clusters, False, dev)
    qs = centers[torch.arange(n_q, device=dev) % n_clusters] + 0.05 * torch.randn(
        (n_q, 128), generator=gen, device=dev)
    full = itt.batch_knn_dot(qs, itt.VerticalBatch(rows), k)
    index, counts = path("IVFIndex build", ["nearest_centroid<float32>"],
                         lambda: itt.IVFIndex(rows, n_clusters=n_clusters, metric="dot",
                                              n_iters=3))
    res, _ = path("IVFIndex.search_batch", ["knn_scan_tiles+knn_merge<float32>"],
                  lambda: index.search_batch(qs, k))
    _same_result("IVFIndex.search_batch", res, full)
    surv, tiles = index.plan_stats(qs, k)
    log(f"[main] IVFIndex ({n} x 128, {n_clusters} clusters, dot, n_iters=3): search_batch "
        f"equals batch_knn_dot bit for bit; plan_stats {surv} of {tiles} tiles "
        f"({1.0 - surv / tiles!r} elided), tile {index.tile_n}, padding_fraction "
        f"{index.padding_fraction!r}, {index.memory_bytes()} bytes")
    search_ms = _median_host_ms(lambda: index.search_batch(qs, k))
    del index
    torch.cuda.empty_cache()
    build_ms = _median_host_ms(lambda: (itt.IVFIndex(rows, n_clusters=n_clusters, metric="dot",
                                                     n_iters=3), torch.cuda.synchronize()),
                               reps=1)
    # The build's k-means++ seeding alone, on a seed pool of the build's
    # size (8192 sampled rows), with its own generator.
    pool = rows[torch.randint(0, n, (8192,), generator=gen, device=dev)].float()
    seed_ms = _median_host_ms(lambda: (kmeanspp_seed(pool, torch.Generator(device=dev)
                                                     .manual_seed(SEED), n_clusters),
                                       torch.cuda.synchronize()), reps=3)
    log(f"[timing] IVFIndex build host time {_scan_equivalents(build_ms, full_ms)}, of which "
        f"the k-means++ seeding ({n_clusters - 1} steps, CUDA graph of {SEED_CHUNK}-step "
        f"chunks, 8192-row pool) {seed_ms!r} ms (median of 3); search_batch of {n_q} "
        f"queries, k={k}, host copy included: {search_ms!r} ms")
    cent = centers + 0.1 * torch.randn(centers.shape, generator=gen, device=dev)
    errs["nearest_centroid"] = max(errs["nearest_centroid"], _assign_check(
        f"nearest_centroid {n} x 128, KC={n_clusters}", rows, cent,
        ta.nearest_centroid(rows, cent), ta.nearest_centroid_plain(rows, cent)))
    shortlist = _shortlist_log(f"nearest_centroid {n} x 128, KC={n_clusters}")
    kernel = _median_ms(lambda: ta.nearest_centroid(rows, cent), reps=3)
    plain_ms = _median_ms(lambda: ta.nearest_centroid_plain(rows, cent), reps=3)
    log(f"[timing] nearest_centroid {n} x 128, KC={n_clusters}: kernel {kernel!r} ms, plain "
        f"{plain_ms!r} ms (median of 3), {bound_text(assign_bound(n_clusters, shortlist))}")
    del rows, full
    torch.cuda.empty_cache()
    return total, times


def _shortlist_log(name: str) -> int:
    """Logs the last nearest-centroid launch's shortlist (mean and largest
    per row) and returns its total of exactly re-scored pairs."""
    from innr_tpu_torch.kernels import assign as ta

    rows_n, total, top = ta.shortlist_stats()
    log(f"[main] {name}: shortlist of {total} re-scored pairs, mean {total / rows_n!r} and "
        f"largest {top} per row")
    return total


def _assign_check(name: str, rows, cent, got, want) -> float:
    """The kernel's assignments against the plain version's. Where they
    differ, the float64 scores ||c||^2 - 2 x.c of the two chosen centroids
    must lie within the f32 rounding of both, 32 eps (||c||^2 + 2 |x|.|c|)
    each; else it raises. Returns the largest score gap (0 if all agree)."""
    import torch

    bad = torch.nonzero(got != want).flatten()
    if bad.numel() == 0:
        log(f"[main] {name}: kernel assignments equal the plain version's")
        return 0.0
    x, c = rows[bad].double(), cent.double()
    a, b = c[got[bad].long()], c[want[bad].long()]
    sa = (a * a).sum(1) - 2 * (x * a).sum(1)
    sb = (b * b).sum(1) - 2 * (x * b).sum(1)
    bound = 32 * EPS32 * ((a * a).sum(1) + (b * b).sum(1)
                          + 2 * (x.abs() * (a.abs() + b.abs())).sum(1))
    gap = (sa - sb).abs()
    if not bool((gap <= bound).all()):
        raise AssertionError(f"{name}: {int((~(gap <= bound)).sum())} of {bad.numel()} "
                             "differing assignments beyond rounding")
    log(f"[main] {name}: {bad.numel()} of {rows.shape[0]} assignments differ from the plain "
        f"version's, each within rounding (largest score gap {float(gap.max())!r})")
    return float(gap.max())


def _timed(name: str, kernel, plain, read, pops: int, b: tuple) -> tuple:
    """Kernel, plain and same-bytes read medians; logs the roofline fraction,
    word scores per ms (``pops`` words of a row scored against a query per
    call) and the bound ``b``."""
    k_ms, p_ms, r_ms = _median_ms(kernel), _median_ms(plain), _median_ms(read)
    log(f"[timing] {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms, same-bytes read "
        f"{r_ms!r} ms, roofline fraction (read/kernel) {r_ms / k_ms!r}, "
        f"word scores per ms {pops / k_ms!r}, {bound_text(b)}")
    return k_ms, p_ms, r_ms


def _check_path(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"the {path} path launched no {name}")


def phase_packed(dev, bounds: dict) -> tuple[dict, dict, dict]:
    """3b and its timing: the packed families at full size. Returns the
    path's launches, and per kernel its times and max abs error; fills
    ``bounds``."""
    import numpy as np
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import hamming as th
    from innr_tpu_torch.kernels import knn as tk
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

    def scan_bound(n, planes, n_q, k):
        """Word planes read once, queries read, (Q, k) keys and rows written;
        the products on the b1 tensor cores: 32 W bits per row and query,
        plus popc(x) as one more column (binary), or both planes against
        both query planes (ternary)."""
        cols = n_q + 1 if planes == 1 else 4 * n_q
        return bound(4 * w * planes * (n + n_q) + 8 * n_q * k, b1=n * 32 * w * cols)

    def rows_bound(n, planes):
        return bound(4 * w * planes * (n + 1) + 4 * n, popc=n * w * planes)

    bounds["packed_scan<binary>"] = scan_bound(30_000_000, 1, n_q, k)
    bounds["packed_scan<ternary>"] = scan_bound(15_000_000, 2, n_q, k)
    bounds["packed_rows<binary>"] = rows_bound(30_000_000, 1)
    bounds["packed_rows<ternary>"] = rows_bound(15_000_000, 2)
    scan_pops = 30_000_000 * w * n_q  # ternary: 2 words a row over half the rows
    times["packed_scan<binary>"] = _timed(
        f"packed_scan<binary> 30M x {d} bits, Q={n_q}, k={k}",
        lambda: tp.fused_packed_keys_batch((qb,), (bb.words_t,), k),
        lambda: tp.packed_knn_plain((qb,), (bb.words_t,), k),
        lambda: bb.words_t.view(torch.float32).sum(), scan_pops, bounds["packed_scan<binary>"])
    times["packed_scan<ternary>"] = _timed(
        f"packed_scan<ternary> 15M x {d}, Q={n_q}, k={k}",
        lambda: tp.fused_packed_keys_batch((qtp, qtn), (tb.pos_t, tb.neg_t), k),
        lambda: tp.packed_knn_plain((qtp, qtn), (tb.pos_t, tb.neg_t), k),
        lambda: tb.pos_t.view(torch.float32).sum() + tb.neg_t.view(torch.float32).sum(),
        scan_pops, bounds["packed_scan<ternary>"])
    _timed(f"packed_scan<binary> 1M x {d} bits, Q=1, k={k1}",
           lambda: tp.fused_packed_keys_batch((qb[:1],), (bb1.words_t,), k1),
           lambda: tp.packed_knn_plain((qb[:1],), (bb1.words_t,), k1),
           lambda: bb1.words_t.view(torch.float32).sum(), n1 * w, scan_bound(n1, 1, 1, k1))
    _timed(f"packed_scan<ternary> 1M x {d}, Q=1, k={k1}",
           lambda: tp.fused_packed_keys_batch((qtp[:1], qtn[:1]), (tb1.pos_t, tb1.neg_t), k1),
           lambda: tp.packed_knn_plain((qtp[:1], qtn[:1]), (tb1.pos_t, tb1.neg_t), k1),
           lambda: tb1.pos_t.view(torch.float32).sum() + tb1.neg_t.view(torch.float32).sum(),
           2 * n1 * w, scan_bound(n1, 2, 1, k1))
    # TwoStageIndex's coarse shape (3 of the 5 launches per kind on the main
    # paths): 32 queries, k = 256 a pass, over the 1M-row corpora.
    (qb32,), (qtp32, qtn32) = planes(gen, "binary", (32, w), dev), planes(gen, "ternary", (32, w),
                                                                           dev)
    kc = tk.single_pass_k(32)
    for name, qs, rows_t, n_planes in (
            ("binary", (qb32,), (bb1.words_t,), 1),
            ("ternary", (qtp32, qtn32), (tb1.pos_t, tb1.neg_t), 2)):
        same(f"packed_scan<{name}> 1M Q=32 k={kc}", tp.fused_packed_keys_batch(qs, rows_t, kc),
             tp.packed_knn_plain(qs, rows_t, kc))
        _timed(f"packed_scan<{name}> 1M x {d}{' bits' if n_planes == 1 else ''}, Q=32, k={kc} "
               f"(TwoStageIndex's coarse shape)",
               lambda: tp.fused_packed_keys_batch(qs, rows_t, kc),
               lambda: tp.packed_knn_plain(qs, rows_t, kc),
               lambda: sum(p.view(torch.float32).sum() for p in rows_t),
               n_planes * n1 * w * 32, scan_bound(n1, n_planes, 32, kc))
    times["packed_rows<binary>"] = _timed(
        f"packed_rows<binary> 30M x {d} bits",
        lambda: th.packed_rows((qb[0],), (bb.words,)),
        lambda: th.hamming_rows_plain((qb[0],), (bb.words,)),
        lambda: bb.words.view(torch.float32).sum(), 30_000_000 * w, bounds["packed_rows<binary>"])
    times["packed_rows<ternary>"] = _timed(
        f"packed_rows<ternary> 15M x {d}",
        lambda: th.packed_rows((qtp[0], qtn[0]), (tb.pos, tb.neg)),
        lambda: th.hamming_rows_plain((qtp[0], qtn[0]), (tb.pos, tb.neg)),
        lambda: tb.pos.view(torch.float32).sum() + tb.neg.view(torch.float32).sum(),
        2 * 15_000_000 * w, bounds["packed_rows<ternary>"])
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


def _random_slots(gen, n: int, s: int, dtype, dev):
    """(n, s) slots drawn over the full width of the view type, in chunks."""
    import torch

    info = torch.iinfo(dtype)
    out = torch.empty((n, s), dtype=dtype, device=dev)
    for a in range(0, n, 1 << 20):
        b = min(n, a + (1 << 20))
        out[a:b] = torch.randint(info.min, info.max + 1, (b - a, s), generator=gen, device=dev,
                                 dtype=dtype)
    return out


def _slot_cell(name: str, qs, slots_t, k: int, q: int, reps: int = 7) -> tuple:
    """One slot cell at Q = q: the scan (the plan's mode) against its plain
    version, bit for bit, then the kernel, plain and a same-bytes read
    timed. Logs them beside the bound (the read: each slot once, the
    queries, the result), the design's own work (compares, or filter
    lookups a tile, and the filter passes and hits of slot_table_plain's
    model, which the kernel does not count) and the shared memory of a
    CTA. Returns (kernel,
    plain) ms."""
    import torch

    from innr_tpu_torch.kernels import slot_knn as tsl

    s, n = slots_t.shape
    bits = torch.iinfo(slots_t.dtype).bits
    qs = qs[:q].contiguous()
    want = tsl.slot_knn_plain(qs, slots_t, k)
    expect_equal(f"{name} Q={q}", tsl.fused_slot_keys_batch(qs, slots_t, k), want)
    kernel = _median_ms(lambda: tsl.fused_slot_keys_batch(qs, slots_t, k))
    plain = _median_ms(lambda: tsl.slot_knn_plain(qs, slots_t, k), reps=reps)
    read = _median_ms(lambda: slots_t.view(torch.float32).sum())
    b = _slot_bound(bits, n, s, q, k)
    mode, tile = tsl.plan(q, k, s, bits)
    if mode == "compare":
        ops_ms = 2 * n * s * q / PEAK_OPS_PER_S["int32"] * 1e3
        work = f"{n * s * q} compares and adds ({ops_ms!r} ms at the INT32 rate)"
    else:
        stats = tsl.slot_table_plain(qs, slots_t, tile)
        lookups = n * s * -(-q // tile)
        work = (f"{lookups} filter lookups ({lookups / PEAK_OPS_PER_S['shared'] * 1e3!r} ms at the "
                f"shared-load rate); by slot_table_plain's model of the table (not counted by "
                f"the kernel): filter passes per (row, slot) {stats.passes / (n * s)!r}, hits "
                f"per (row, slot) {stats.hits / (n * s)!r}")
    log(f"[timing] {name} {n} x {s}, Q={q}, k={k}: kernel {kernel!r} ms, plain {plain!r} ms, "
        f"same-bytes read {read!r} ms, share (bound/kernel) {b[0] / kernel!r}, roofline fraction "
        f"(read/kernel) {read / kernel!r}, {bound_text(b)}; mode {mode}, query tile {tile}, "
        f"shared memory {tsl.smem_bytes(bits, mode, tile, s, k)} bytes a CTA; design work: "
        f"{work}")
    return kernel, plain


def _slot_bound(bits: int, n: int, s: int, q: int, k: int) -> tuple:
    """The slot scan's bound: its read (each slot once, the queries, the
    (Q, k) int32 counts and indices)."""
    return bound(bits // 8 * (n * s + q * s) + 8 * q * k)


def phase_slot(dev, errs: dict, bounds: dict) -> tuple[dict, dict]:
    """3e and its timing: MinHash retrieval on 10M x 128 uint32 and uint16
    SketchCorpora, each path with the counters reset just before it and
    read just after; then each width at Q = 16 (the table scan) and Q = 1
    (the compare scan) against the read, on full-width slots and on a
    hit-heavy corpus (slots from 4 values, queries drawn from it), the
    worst case of the table scan. Returns the paths' launches and each
    width's (ms, plain ms) at Q = 16."""
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import slot_knn as tsl

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    n, s, n_q, k = N_SKETCH, SLOTS, 16, 10
    total, times = {}, {}
    for dtype in (torch.int32, torch.int16):
        bits = torch.iinfo(dtype).bits
        name = f"slot_scan<uint{bits}>"
        sketches = _random_slots(gen, n, s, dtype, dev)
        # Near-duplicate queries: corpus rows with 13 of 128 slots redrawn
        # (Jaccard about 0.9), each row also planted at a later row, so
        # that two rows tie at the smallest count (the lower one first).
        rows = torch.arange(n_q, device=dev) * (n // n_q) + 12_345
        sketches[(rows + 1_000_003) % n] = sketches[rows]
        qs = sketches[rows].clone()
        qs[:, :13] = _random_slots(gen, n_q, 13, dtype, dev)
        corpus = itt.SketchCorpus(sketches)
        torch.cuda.synchronize()
        reset_counts()
        fn = itt.slot_knn_u32 if bits == 32 else itt.slot_knn_u16
        fn_batch = itt.slot_knn_u32_batch if bits == 32 else itt.slot_knn_u16_batch
        batch = fn_batch(qs, corpus, k)
        one = fn(qs[0], corpus, k)
        sims, sims_idx = itt.minhash_knn_batch(qs, corpus, k)
        torch.cuda.synchronize()
        counts = read_counts()
        _check_path(f"MinHash uint{bits}", counts, [name])
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
        keys, idx = tsl.slot_knn_plain(qs, corpus.slots_t, k)
        expect_equal(f"slot_knn_u{bits}_batch {n} x {s}", (-batch[0], batch[1]), (keys, idx))
        expect_equal(f"slot_knn_u{bits}", (-one[0][None], one[1][None]), (keys[:1], idx[:1]))
        want = 1.0 - (-keys).to(torch.float32) / torch.tensor(float(s), device=dev)
        if not (torch.equal(sims_idx, idx) and bits_equal(sims, want)):
            raise AssertionError(f"minhash_knn_batch uint{bits}: != 1 - plain count / S")
        errs[name] = 0.0  # counts are exact
        log(f"[main] MinHash {n} x {s} uint{bits}: slot_knn_u{bits}_batch (Q={n_q}), "
            f"slot_knn_u{bits} and minhash_knn_batch (k={k}) equal the plain version; "
            f"best counts {(-keys[:4, 0]).tolist()} at rows {idx[:4, 0].tolist()}, "
            f"launches {counts[name]}")

        bounds[name] = _slot_bound(bits, n, s, n_q, k)
        times[name] = _slot_cell(name, qs, corpus.slots_t, k, n_q)
        _slot_cell(name, qs, corpus.slots_t, k, 1)
        del corpus, sketches
        torch.cuda.empty_cache()
        # The hit-heavy corpus: every slot one of 4 values (the sign bit
        # set in one), queries 16 of its rows: nearly every (row, slot)
        # passes the filter and hits the table.
        info = torch.iinfo(dtype)
        alphabet = torch.tensor([info.min, -1, 0, 1], dtype=dtype, device=dev)
        heavy = torch.empty((s, n), dtype=dtype, device=dev)
        for a in range(0, n, 1 << 20):
            b = min(n, a + (1 << 20))
            heavy[:, a:b] = alphabet[torch.randint(0, 4, (s, b - a), generator=gen, device=dev)]
        qs = heavy[:, rows].T.contiguous()
        _slot_cell(f"{name} hit-heavy (4 values)", qs, heavy, k, n_q, reps=3)
        _slot_cell(f"{name} hit-heavy (4 values)", qs, heavy, k, 1, reps=3)
        del heavy
        torch.cuda.empty_cache()
    return total, times


def _zipf_sparse_corpus(gen, dev, perm, cdf):
    """N_SPARSE documents of ENTRIES ids drawn from the Zipf law ``cdf``
    over ranks (``perm`` maps a rank to its id), values |N(0, 1)|, each row
    sorted as unsigned with repeats as sentinel padding."""
    import torch

    ids = torch.empty((N_SPARSE, ENTRIES), dtype=torch.int32, device=dev)
    vals = torch.empty((N_SPARSE, ENTRIES), dtype=torch.float32, device=dev)
    for a in range(0, N_SPARSE, 1 << 20):
        b = min(N_SPARSE, a + (1 << 20))
        u = torch.rand((b - a, ENTRIES), generator=gen, device=dev)
        ranks = torch.searchsorted(cdf, u).clamp_(max=VOCAB - 1)
        v = torch.randn((b - a, ENTRIES), generator=gen, device=dev).abs_()
        ids[a:b], vals[a:b] = sparse_rows(perm[ranks], v)
    return ids, vals


def phase_sparse(dev, errs: dict, bounds: dict) -> tuple[dict, dict]:
    """3f and its timing: learned-sparse retrieval on two 10M x 32
    SparseCorpora (WordPiece ids, then ids hashed over the full 32 bits),
    each path with the counters reset just before it and read just after.
    Returns the paths' launches and the sparse scan's (ms, plain ms) at
    Q = 1 on the WordPiece corpus."""
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import sparse_knn as tsp
    from innr_tpu_torch.utils.order import invert_total_key

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    n, l, lq, n_q, k = N_SPARSE, ENTRIES, QUERY_NNZ, 16, 10
    # Zipf's law with exponent 1 over the vocabulary's frequency ranks.
    p = 1.0 / torch.arange(1, VOCAB + 1, dtype=torch.float64, device=dev)
    cdf = (torch.cumsum(p, 0) / p.sum()).float()
    perm = torch.randperm(VOCAB, generator=gen, device=dev).to(torch.int32)
    ranks = torch.stack([torch.multinomial(p.float(), lq, replacement=False, generator=gen)
                         for _ in range(n_q)])
    q_val = torch.randn((n_q, lq), generator=gen, device=dev).abs_()
    total, times = {}, {}
    hashed = torch.randint(-(2**31), 2**31, (VOCAB,), generator=gen, device=dev,
                           dtype=torch.int32)
    hashed[hashed == -1] = 0  # keep the sentinel out of the id space
    for space in ("WordPiece", "hashed 32-bit"):
        to_id = perm if space == "WordPiece" else hashed[perm.long()]
        ids, vals = _zipf_sparse_corpus(gen, dev, to_id, cdf)
        q_idx, order = unsigned_sort(to_id[ranks], 1)
        qv = torch.gather(q_val, 1, order)
        corpus = itt.SparseCorpus((ids, vals))
        idx_t, val_t = corpus._transposed()
        torch.cuda.synchronize()
        reset_counts()
        one = itt.sparse_knn((q_idx[0], qv[0]), corpus, k)
        batch = itt.sparse_knn_batch((q_idx, qv), corpus, k)
        torch.cuda.synchronize()
        counts = read_counts()
        _check_path(f"sparse ({space})", counts, ["sparse_scan"])
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
        pk, pi = tsp.sparse_knn_plain(q_idx, qv, idx_t, val_t, k + 1)
        want = invert_total_key(pk)
        # 32 eps of the largest possible sum of |products| (cond_tol).
        tol = (32 * EPS32 * float(vals.abs().sum(1).max())
               * qv.abs().max(1, keepdim=True).values.double())
        err = check_close(f"sparse_knn_batch ({space})", *batch, want, pi, tol)
        err = max(err, check_close(f"sparse_knn ({space})", one[0][None], one[1][None],
                                   want[:1], pi[:1], tol[:1]))
        errs["sparse_scan"] = max(errs.get("sparse_scan", 0.0), err)
        padding = float((ids == -1).float().mean())
        log(f"[main] sparse {n} x {l} ({space} ids, {padding!r} of entries padding): "
            f"sparse_knn and sparse_knn_batch ({n_q} queries of {lq}, k={k}) agree with the "
            f"plain version (max abs err {err!r}), launches {counts['sparse_scan']}")

        def sparse_bound(q):
            # The function's own least work, not this kernel's: one shared
            # lookup per corpus entry serves the whole batch (a table of
            # the batch's ids), and the matched products, fewer than
            # n * l * q FMAs, stay far below the bytes at any q here.
            return bound(8 * (n * l + q * lq) + 8 * q * k, shared=n * l)

        read = lambda: idx_t.view(torch.float32).sum() + val_t.sum()  # noqa: E731
        for q, reps in ((1, 7), (n_q, 3)):
            kernel = _median_ms(lambda: tsp.fused_sparse_keys_batch(q_idx[:q], qv[:q], idx_t,
                                                                    val_t, k))
            plain = _median_ms(lambda: tsp.sparse_knn_plain(q_idx[:q], qv[:q], idx_t, val_t, k),
                               reps=reps)
            read_ms = _median_ms(read)
            if q == 1 and space == "WordPiece":
                times["sparse_scan"] = (kernel, plain)
                bounds["sparse_scan"] = sparse_bound(1)
            log(f"[timing] sparse_scan {n} x {l} ({space}), Q={q}, Lq={lq}, k={k}: kernel "
                f"{kernel!r} ms, plain {plain!r} ms, same-bytes read {read_ms!r} ms, roofline "
                f"fraction (read/kernel) {read_ms / kernel!r}, {bound_text(sparse_bound(q))}")
        del corpus, ids, vals, idx_t, val_t
        torch.cuda.empty_cache()
    return total, times


def _int_tokens(gen, shape, lo, hi, dev):
    """float32 tokens with integer values in [lo, hi]."""
    import torch

    return torch.randint(lo, hi + 1, shape, generator=gen, device=dev).float()


def phase_exact_maxsim(dev) -> int:
    """The MaxSim scan (K11/K12) against its plain version, bit for bit, on
    integer-valued tokens (every dot and sum is then exact in any order):
    f32 and bf16 documents, no mask / ragged masks with a fully masked
    document / random masks, planted NaN, +inf and -inf tokens, the R7
    input (an inf in one query of the batch), and top_k_total ties."""
    import torch

    from innr_tpu_torch.kernels import maxsim_kernel as tm

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    n = 1024 + 13
    checks = 0

    def expect_scores(name, got, want):
        if not bits_equal(got, want):
            bad = ~((got == want) | (torch.isnan(got) & torch.isnan(want)))
            b, j = (int(v) for v in bad.nonzero()[0])
            raise AssertionError(f"{name}: query {b} doc {j}: kernel {float(got[b, j])!r} "
                                 f"plain {float(want[b, j])!r}")

    for dtype in (torch.float32, torch.bfloat16):
        for td, d in ((1, 1), (5, 96), (5, 130), (180, 128), (1, 128), (180, 1)):
            docs = _int_tokens(gen, (n, td, d), -4, 4, dev)
            docs[3, 0, 0] = float("nan")
            docs[17, td - 1, 0] = float("inf")
            docs[40, :, 0] = -float("inf")
            docs[[100, n - 1]] = docs[5].clone()  # ties go to the lowest document
            docs = docs.to(dtype)
            lengths = torch.randint(1, td + 1, (n,), generator=gen, device=dev)
            lengths[7] = 0  # a fully masked document
            ragged = torch.arange(td, device=dev)[None, :] < lengths[:, None]
            ragged[[100, n - 1]] = ragged[5].clone()
            scattered = torch.rand((n, td), generator=gen, device=dev) < 0.6
            for mask_name, mask in (("no mask", None), ("ragged", ragged),
                                    ("scattered", scattered)):
                for tq in (1, 7, 32, 33):
                    for n_b in (1, 3, 16, 17):
                        qs = _int_tokens(gen, (n_b, tq, d), -3, 3, dev)
                        if n_b > 1:
                            qs[1, 0, 0] = float("inf")  # R7: query 1 only
                        name = f"exact maxsim_scores<{str(dtype)[6:]}> td={td} d={d} tq={tq} " \
                               f"b={n_b} {mask_name}"
                        before = tm.LAUNCHES
                        got = tm.fused_maxsim_scores_batch(qs, docs, mask)
                        if tm.LAUNCHES != before + 1:
                            raise AssertionError(f"{name}: the kernel did not launch")
                        expect_scores(name, got, tm.maxsim_scores_plain(qs, docs, mask))
                        checks += 1
                        if n_b > 1 and tq == 7:
                            # Each query scored on its own: the batch row of
                            # every query equals its single-query launch.
                            for b in (0, 1, n_b - 1):
                                one = tm.fused_maxsim_scores(qs[b], docs, mask)
                                expect_scores(f"{name} R7 query {b}", got[b:b + 1], one[None])
                            if not bool(torch.isfinite(got[0]).any()):
                                raise AssertionError(f"{name}: query 0 took query 1's inf")
                            checks += 1
                        if tq == 32 and n_b in (1, 16):
                            for k in (1, 10):
                                vals, idx = tm.fused_maxsim_knn_batch(qs, docs, k, mask)
                                pv, pi = tm._top(tm.maxsim_scores_plain(qs, docs, mask), k)
                                if not (bits_equal(vals, pv) and torch.equal(idx, pi)):
                                    raise AssertionError(f"{name} k={k}: top-k != plain")
                                checks += 1
    # Shapes beyond one bf16 tile: documents in several segments (a NaN and
    # the only valid tokens in late ones), a query scored in two passes.
    for td, d, tq, n_b in ((700, 128, 32, 16), (60, 1024, 32, 1), (9, 16, 700, 2)):
        docs = _int_tokens(gen, (n, td, d), -4, 4, dev)
        docs[3, td - 1, 0] = float("nan")
        docs[40, :, 0] = -float("inf")
        mask = torch.rand((n, td), generator=gen, device=dev) < 0.9
        mask[3, td - 1] = True
        mask[7, : td - 2] = False
        qs = _int_tokens(gen, (n_b, tq, d), -3, 3, dev)
        for dtype in (torch.float32, torch.bfloat16):
            for mask_name, m in (("no mask", None), ("scattered", mask)):
                name = f"exact maxsim_scores<{str(dtype)[6:]}> td={td} d={d} tq={tq} b={n_b} " \
                       f"{mask_name}"
                got = tm.fused_maxsim_scores_batch(qs, docs.to(dtype), m)
                expect_scores(name, got, tm.maxsim_scores_plain(qs, docs.to(dtype), m))
                checks += 1
    torch.cuda.synchronize()
    log(f"[exact] {checks} MaxSim checks agree bit for bit (scores, R7 rows, top-k ties, bf16 "
        f"segments and passes)")
    return checks + _exact_maxsim_near_ties(dev, expect_scores)


def _exact_maxsim_near_ties(dev, expect_scores) -> int:
    """The f32 MaxSim kernel's tensor-core gate on exact arithmetic that
    TF32 cannot represent: document tokens of odd integers 2049-4095 in
    magnitude (TF32 drops each one's low bit) and query tokens with two
    nonzero dimensions in [-3, 3], dimension 0 always among them, so every
    FMA dot is an exact integer below 2^15 and every score below 2^24.
    Near ties: in every document, token 1 copies token 0 with coordinate 0
    one nearer zero (an even integer, exact in TF32), so their TF32 dots
    tie and their exact dots differ by q[0]; token 2 copies token 0 with
    coordinate 0 negated. Ragged masks (a fully masked document), NaN, +inf
    and -inf tokens, an inf in one query of each batch (every query's row
    equals its single-query launch: ROADMAP R7), Tq in {32, 200}, D in {20,
    128, 130, 1024} (1024: the query tile staged per block), B in {1, 3,
    16} (16: two query tiles), Td in {180, 1500} (many items, and two
    segments of positions). Kernel equal to the plain version bit for bit;
    logs the re-scored pairs (``maxsim_rescore_stats``)."""
    import torch

    from innr_tpu_torch.kernels import maxsim_kernel as tm

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    checks = 0
    for n, td, d, tq, n_b in ((1037, 180, 128, 32, 16), (1037, 180, 130, 200, 3),
                              (1037, 180, 20, 32, 1), (300, 1500, 128, 32, 16),
                              (300, 60, 1024, 32, 3)):
        mag = 2 * torch.randint(1024, 2048, (n, td, d), generator=gen, device=dev) + 1
        sign = torch.where(torch.rand((n, td, d), generator=gen, device=dev) < 0.5, -1, 1)
        docs = (mag * sign).float()
        docs[:, 1] = docs[:, 0]
        docs[:, 1, 0] -= torch.sign(docs[:, 0, 0])
        docs[:, 2] = docs[:, 0]
        docs[:, 2, 0] = -docs[:, 0, 0]
        docs[3, 5, 0] = float("nan")
        docs[17, 0, 0] = float("inf")
        docs[40, 1, 1] = -float("inf")
        lengths = torch.randint(3, td + 1, (n,), generator=gen, device=dev)
        lengths[7] = 0  # a fully masked document
        mask = torch.arange(td, device=dev)[None, :] < lengths[:, None]
        qs = torch.zeros((n_b, tq, d), device=dev)
        rows = torch.arange(n_b * tq, device=dev)
        other = torch.randint(1, d, (n_b * tq,), generator=gen, device=dev)
        vals = torch.randint(1, 4, (n_b * tq, 2), generator=gen, device=dev).float()
        vals *= torch.where(torch.rand((n_b * tq, 2), generator=gen, device=dev) < 0.5, -1, 1)
        flat = qs.view(n_b * tq, d)
        flat[rows, 0] = vals[:, 0]
        flat[rows, other] = vals[:, 1]
        if n_b > 1:
            qs[1, 0, 0] = float("inf")  # R7: query 1 only
        for mask_name, m in (("no mask", None), ("ragged", mask)):
            name = f"exact TF32 near ties maxsim_scores<float32> n={n} td={td} d={d} tq={tq} " \
                   f"b={n_b} {mask_name}"
            got = tm.fused_maxsim_scores_batch(qs, docs, m)
            n_tok, n_docs, pairs = tm.maxsim_rescore_stats()
            expect_scores(name, got, tm.maxsim_scores_plain(qs, docs, m))
            checks += 1
            if n_b > 1:
                for b in (0, 1, n_b - 1):
                    one = tm.fused_maxsim_scores(qs[b], docs, m)
                    expect_scores(f"{name} R7 query {b}", got[b:b + 1], one[None])
                checks += 1
            log(f"[exact] {name}: re-scored {pairs} pairs, {pairs / (n_tok * n_docs)!r} per "
                f"(query token, document)")
    torch.cuda.synchronize()
    log(f"[exact] {checks} MaxSim TF32 near-tie checks agree bit for bit")
    return checks


def _colbert_corpus(gen, dev):
    """N_MAXSIM documents of MAXSIM_TD unit-norm MAXSIM_D-dim f32 token
    embeddings, lengths clip(round(N(80, 30)), 8, 180) as a bool mask; the
    padded tokens hold random data, which the mask must keep out."""
    import torch

    n, td, d = N_MAXSIM, MAXSIM_TD, MAXSIM_D
    docs = torch.empty((n, td, d), dtype=torch.float32, device=dev)
    for a in range(0, n, 1 << 14):
        b = min(n, a + (1 << 14))
        x = torch.randn((b - a, td, d), generator=gen, device=dev)
        docs[a:b] = x / x.norm(dim=2, keepdim=True)
    lengths = (torch.randn(n, generator=gen, device=dev) * 30 + 80).round().clamp(8, td).long()
    mask = torch.arange(td, device=dev)[None, :] < lengths[:, None]
    return docs, mask, lengths


def phase_maxsim(dev, errs: dict, bounds: dict) -> tuple[dict, dict]:
    """3g and its timing: ColBERT retrieval through the public maxsim_knn
    (Q=1) and maxsim_knn_batch (B=16), and the kernel module's batch call
    on the same corpus in bf16, counters reset just before and read just
    after. Returns the path's launches and each dtype's (ms, plain ms) at
    B=16."""
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import maxsim_kernel as tm

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    n, td, d, tq, n_b, k = N_MAXSIM, MAXSIM_TD, MAXSIM_D, MAXSIM_TQ, 16, 10
    docs, mask, lengths = _colbert_corpus(gen, dev)
    # Near-duplicate queries: 32 tokens drawn from the valid tokens of a
    # planted document, plus noise, renormalized.
    planted = torch.arange(n_b, device=dev) * (n // n_b) + n // (2 * n_b)
    pick = (torch.rand((n_b, tq), generator=gen, device=dev) * lengths[planted, None]).long()
    qs = docs[planted[:, None], pick] + 0.1 * torch.randn((n_b, tq, d), generator=gen, device=dev)
    qs = qs / qs.norm(dim=2, keepdim=True)
    docs16 = docs.to(torch.bfloat16)
    torch.cuda.synchronize()

    reset_counts()
    one = itt.maxsim_knn(qs[0], docs, k, doc_mask=mask)
    batch = itt.maxsim_knn_batch(qs, docs, k, doc_mask=mask)
    batch16 = tm.fused_maxsim_knn_batch(qs, docs16, k, mask)
    torch.cuda.synchronize()
    counts = read_counts()
    _check_path("MaxSim", counts, ["maxsim_scores<float32>", "maxsim_scores<bfloat16>"])
    n_tok, n_docs, pairs = tm.maxsim_rescore_stats()  # maxsim_knn_batch's launch
    log(f"[main] maxsim_knn_batch re-scored {pairs} (query token, document token) pairs, "
        f"{pairs / (n_tok * n_docs)!r} per (query token, document)")

    # 32 eps of the largest sum of |products| a score can hold: per query
    # token |q_i| max |d_j| (Cauchy-Schwarz), summed over the tokens.
    max_d = max(float(docs[a:a + (1 << 14)].norm(dim=2).max()) for a in range(0, n, 1 << 14))
    tol = (64 * EPS32 * max_d * qs.norm(dim=2).sum(dim=1, keepdim=True)).double()
    pv, pi = tm._top(tm.maxsim_scores_plain(qs, docs, mask), k + 1)
    err = check_close("maxsim_knn_batch", *batch, pv, pi, tol)
    err = max(err, check_close("maxsim_knn", one[0][None], one[1][None], pv[:1], pi[:1],
                               tol[:1]))
    # Scores within tol, and the indices exactly the plain version's: the
    # planted answers stand far apart, and the seeded corpus is fixed.
    if not (torch.equal(batch[1], pi[:, :k]) and torch.equal(one[1], pi[0, :k])):
        raise AssertionError("maxsim_knn(_batch): indices differ from the plain version's")
    if not torch.equal(batch[1][:, 0], planted.to(torch.int32)):
        raise AssertionError(f"maxsim_knn_batch: planted documents {planted.tolist()} not "
                             f"first: {batch[1][:, 0].tolist()}")
    errs["maxsim_scores<float32>"] = err
    pv16, pi16 = tm._top(tm.maxsim_scores_plain(qs, docs16, mask), k + 1)
    errs["maxsim_scores<bfloat16>"] = check_close("fused_maxsim_knn_batch bf16", *batch16,
                                                  pv16, pi16, tol)
    valid = int(lengths.sum())
    log(f"[main] MaxSim {n} x {td} x {d} ({valid} valid tokens, mean length "
        f"{valid / n!r}): maxsim_knn and maxsim_knn_batch ({n_b} queries of {tq}, k={k}) agree "
        f"with the plain version (max abs err {err!r}, indices identical), every "
        f"planted document first; bf16 fused_maxsim_knn_batch agrees (max abs err "
        f"{errs['maxsim_scores<bfloat16>']!r}); launches {counts['maxsim_scores<float32>']} "
        f"f32, {counts['maxsim_scores<bfloat16>']} bf16")

    def maxsim_bound(q, elem, unit, passes=1):
        """The valid tokens' bytes, the mask, the queries and the scores;
        2 q Tq D operations per valid token on the route's unit (f32
        documents: one TF32 product each; ``passes`` = 3 prices 3xTF32)."""
        return bound(elem * valid * d + n * td + 4 * q * tq * d + 4 * q * n,
                     **{unit: 2 * q * tq * valid * d * passes})

    times = {}
    cells = (("float32", docs, 1, 7), ("float32", docs, n_b, 3), ("bfloat16", docs16, n_b, 3))
    for name, corpus, q, reps in cells:
        elem = corpus.element_size()
        flat = corpus.view(-1)[: valid * d].view(torch.float32)  # the valid tokens' bytes
        kernel = _median_ms(lambda: tm.fused_maxsim_scores_batch(qs[:q], corpus, mask))
        plain = _median_ms(lambda: tm.maxsim_scores_plain(qs[:q], corpus, mask), reps=reps)
        read_ms = _median_ms(lambda: flat.sum())
        b = maxsim_bound(q, elem, "tf32" if name == "float32" else "bf16")
        beside = ""
        if name == "float32":
            tm.fused_maxsim_scores_batch(qs[:q], corpus, mask)
            n_tok, n_docs, pairs = tm.maxsim_rescore_stats()
            beside = (f" (FMA route {bound_text(maxsim_bound(q, elem, 'fp32'))}, 3xTF32 route "
                      f"{bound_text(maxsim_bound(q, elem, 'tf32', 3))}); re-scored {pairs} pairs, "
                      f"{pairs / (n_tok * n_docs)!r} per (query token, document)")
        if q == n_b:
            times[f"maxsim_scores<{name}>"] = (kernel, plain)
            bounds[f"maxsim_scores<{name}>"] = b
        log(f"[timing] maxsim_scores<{name}> {n} x {td} x {d}, B={q}, Tq={tq}: kernel "
            f"{kernel!r} ms, plain {plain!r} ms, same-bytes read {read_ms!r} ms, roofline "
            f"fraction (read/kernel) {read_ms / kernel!r}, {bound_text(b)}, bound/kernel "
            f"{b[0] / kernel!r}{beside}")
    host1 = _median_host_ms(lambda: itt.maxsim_knn(qs[0], docs, k, doc_mask=mask)[0].cpu())
    host16 = _median_host_ms(lambda: itt.maxsim_knn_batch(qs, docs, k, doc_mask=mask)[0].cpu())
    log(f"[timing] public call host time (top-k and host copy included): maxsim_knn "
        f"{host1!r} ms, maxsim_knn_batch (B={n_b}) {host16!r} ms")
    del docs, docs16, mask
    torch.cuda.empty_cache()
    # The TPU record's small cell: 1 x 32 tokens against 256 docs x 128
    # tokens, d = 128: a latency line.
    small = torch.randn((256, 128, 128), generator=gen, device=dev)
    small_ms = _median_ms(lambda: tm.fused_maxsim_scores_batch(qs[:1], small))
    log(f"[timing] maxsim_scores<float32> 256 x 128 x 128, B=1, Tq=32: kernel {small_ms!r} ms, "
        f"{bound_text(bound(4 * small.numel() + 4 * 256, fp32=2 * 32 * 256 * 128 * 128))}")
    return counts, times


# -- phase 5: the slice's repairs and the mutable serving path --------------

def _run_path(name: str, must: list, run, total: dict):
    """Counters from zero, ``run()``, a sync, counters read: every kernel in
    ``must`` launched; the counts add to ``total``. Returns ``(result,
    counts)``."""
    import torch

    reset_counts()
    out = run()
    torch.cuda.synchronize()
    counts = read_counts()
    _check_path(name, counts, must)
    for key, v in counts.items():
        total[key] = total.get(key, 0) + v
    return out, counts


def _int_clustered(gen, n: int, n_centers: int, dev):
    """Integer-valued clustered rows: centres in [-8, 8], each row its centre
    plus integer noise in [-2, 2], in random order. Every dot and squared
    distance is an exact integer, and many rows tie exactly."""
    import torch

    centers = torch.randint(-8, 9, (n_centers, 128), generator=gen, device=dev).float()
    assign = torch.randint(0, n_centers, (n,), generator=gen, device=dev)
    rows = torch.empty((n, 128), device=dev)
    for s in range(0, n, 1 << 20):
        e = min(n, s + (1 << 20))
        rows[s:e] = centers[assign[s:e]] + torch.randint(-2, 3, (e - s, 128), generator=gen,
                                                         device=dev)
    return rows, centers


def phase_ties(dev, total: dict):
    """5a (ROADMAP F2): IVFIndex against the full scan on integer-valued
    clustered corpora (1M x 128, 1024 clusters), where the layout permutes
    the rows and scores tie exactly: dot, l2 and cosine, k in {1, 10, 256,
    259} (259: K1's two passes over the layout with the row-id map), bit for
    bit. Returns the dot index and its queries for phase 5d."""
    import numpy as np
    import torch

    import innr_tpu_torch as itt

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n, n_clusters, n_q = N_TIES, TIES_CLUSTERS, 8
    rows, centers = _int_clustered(gen, n, n_clusters, dev)
    qs = centers[:n_q] + torch.randint(-1, 2, (n_q, 128), generator=gen, device=dev)
    vb = itt.VerticalBatch(rows)
    full = {"dot": itt.batch_knn_dot, "l2": itt.batch_knn, "cosine": itt.batch_knn_cosine}
    kept = None
    for metric, fn in full.items():
        index, _ = _run_path(f"IVFIndex build ({metric})", ["nearest_centroid<float32>"],
                             lambda: itt.IVFIndex(rows, n_clusters=n_clusters, metric=metric,
                                                  n_iters=2), total)
        orig = index.orig_idx
        moved = int((orig[orig >= 0] != torch.arange(n, device=dev)).sum())
        ties = 0
        for k in (1, 10, 256, 259):
            must = ["knn_scan+knn_merge<float32>" if k > 256 else "knn_scan_tiles+knn_merge<float32>"]
            res, _ = _run_path(f"IVFIndex.search_batch ({metric}, k={k})", must,
                               lambda: index.search_batch(qs, k), total)
            want = fn(qs, vb, k)
            _same_result(f"IVFIndex ties ({metric}, k={k})", res, want)
            ties += int((np.diff(want.scores, axis=1) == 0).sum())
        log(f"[main] IVFIndex ties ({n} x 128 integer rows, {n_clusters} clusters, {metric}, "
            f"{moved} rows moved by the layout): search_batch equals {fn.__name__} bit for bit "
            f"at k = 1, 10, 256, 259 ({ties} tied neighbouring ranks in the results)")
        if metric == "dot":
            kept = index
        else:
            del index
    del vb, rows
    torch.cuda.empty_cache()
    return kept, qs


def phase_sparse_long(dev, total: dict) -> None:
    """5b (ROADMAP F3): sparse queries of Lq = 8193 and 20,000 distinct
    WordPiece ids (Q = 1 and 16, k = 10; and Lq = 8193 at k = 256, whose
    table needs global memory even alone) over phase 3f's 10M x 32 Zipf
    corpus with its values rounded to integers (x 8), so every sum is exact
    and the kernel must equal the plain version bit for bit. Each through
    sparse_knn_batch with the counters reset around it; kernel ms (median of
    5), the table's place, the bound and the launches."""
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.kernels import sparse_knn as tsp
    from innr_tpu_torch.utils.order import total_order_key_f32

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    p = 1.0 / torch.arange(1, VOCAB + 1, dtype=torch.float64, device=dev)
    cdf = (torch.cumsum(p, 0) / p.sum()).float()
    perm = torch.randperm(VOCAB, generator=gen, device=dev).to(torch.int32)
    ids, vals = _zipf_sparse_corpus(gen, dev, perm, cdf)
    vals.mul_(8.0).round_()
    corpus = itt.SparseCorpus((ids, vals))
    idx_t, val_t = corpus._transposed()
    n, l = ids.shape
    for lq, n_q, k in ((8193, 1, 10), (8193, 16, 10), (20_000, 1, 10), (20_000, 16, 10),
                       (8193, 1, 256)):
        q_ids = torch.stack([perm[torch.randperm(VOCAB, generator=gen, device=dev)[:lq]]
                             for _ in range(n_q)])
        q_idx, _ = unsigned_sort(q_ids, 1)
        q_val = torch.randint(1, 9, (n_q, lq), generator=gen, device=dev).float()
        (got_s, got_i), counts = _run_path(
            f"sparse_knn_batch (Lq={lq}, Q={n_q}, k={k})", ["sparse_scan"],
            lambda: itt.sparse_knn_batch((q_idx, q_val), corpus, k), total)
        expect_equal(f"sparse_knn_batch Lq={lq} Q={n_q} k={k}",
                     (total_order_key_f32(got_s), got_i),
                     tsp.sparse_knn_plain(q_idx, q_val, idx_t, val_t, k))
        kernel = _median_ms(lambda: tsp.fused_sparse_keys_batch(q_idx, q_val, idx_t, val_t, k),
                            reps=5)
        tile, _, in_global = tsp._table_plan(n_q, lq, k)
        where = f"global memory, {in_global} bytes a tile" if in_global else "shared memory"
        b = bound(8 * (n * l + n_q * lq) + 8 * n_q * k, shared=n * l)
        log(f"[main] sparse_knn_batch {n} x {l} (integer values), Lq={lq}, Q={n_q}, k={k}: "
            f"equal to the plain version bit for bit; query tile {tile}, table in {where}; "
            f"launches {counts['sparse_scan']}; kernel {kernel!r} ms, {bound_text(b)}, "
            f"bound/kernel {b[0] / kernel!r}")
    del corpus, ids, vals, idx_t, val_t
    torch.cuda.empty_cache()


def phase_segmented(dev, total: dict):
    """5c: SegmentedCorpus at 10M x 128 f32 (5.1 GB; integer values), added
    as 8 segments of 1.25M rows; 2% of the ids deleted at random over every
    segment and a contiguous block of 200K in one (4% dead: nothing
    compacts). knn_dot / knn / knn_cosine, Q = 32, k = 10 and 300, each equal
    bit for bit to one batch_knn* scan of the alive rows stacked in
    permanent-id order (ids mapped); then compact() on the device and the
    same checks. Search ms (CUDA events around the call, host copy
    included, median of 7) before and after compaction, K1 launches per
    search, the compact ms and an npz round trip at 100K rows. Returns the
    compacted corpus for phase 5d."""
    import numpy as np
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch.io import load_npz, save_npz

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    n_seg, seg_rows, n_q = N_SEGMENTS, SEGMENT_ROWS, 32
    n = n_seg * seg_rows
    sc = itt.SegmentedCorpus(128, device=dev)
    kept = []
    t0 = time.perf_counter()
    for _ in range(n_seg):
        rows = torch.randn((seg_rows, 128), generator=gen, device=dev).mul_(4.0).round_()
        sc.add(rows)
        kept.append(rows)
    torch.cuda.synchronize()
    add_ms = (time.perf_counter() - t0) * 1e3
    dead = torch.randperm(n, generator=gen, device=dev)[: n // 50].cpu().numpy()
    start = 3 * seg_rows + seg_rows // 12  # a contiguous block in segment 3
    block = np.arange(start, start + n // 50)
    t0 = time.perf_counter()
    n_dead = sc.delete(np.concatenate([dead, block]))
    delete_ms = (time.perf_counter() - t0) * 1e3
    if sc.num_segments != n_seg or sc.num_deleted != n_dead:
        raise AssertionError("SegmentedCorpus compacted below its thresholds")
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[torch.as_tensor(np.concatenate([dead, block]), device=dev)] = False
    alive_ids = torch.nonzero(alive).squeeze(1).cpu().numpy()
    ref = itt.VerticalBatch(torch.cat(kept)[alive])
    del kept
    torch.cuda.empty_cache()
    qs = torch.randint(-4, 5, (n_q, 128), generator=gen, device=dev).float()
    qs_host = qs.cpu().numpy()
    modes = (("knn_dot", itt.batch_knn_dot), ("knn", itt.batch_knn),
             ("knn_cosine", itt.batch_knn_cosine))
    want = {(m, k): fn(qs, ref, k) for m, fn in modes for k in (10, 300)}
    del ref
    torch.cuda.empty_cache()
    log(f"[main] SegmentedCorpus {n} x 128 in {n_seg} segments: add {add_ms!r} ms, delete of "
        f"{n_dead} ids {delete_ms!r} ms, {sc.num_vectors} alive, {sc.memory_bytes()} bytes")

    def check(stage: str) -> dict:
        per_search = {}
        for m, _ in modes:
            for k in (10, 300):
                (s, i), counts = _run_path(f"SegmentedCorpus.{m} ({stage}, k={k})",
                                           ["knn_scan+knn_merge<float32>"],
                                           lambda: getattr(sc, m)(qs_host, k), total)
                w = want[(m, k)]
                if not (np.array_equal(i, alive_ids[w.indices])
                        and np.array_equal(s.view(np.int32), w.scores.view(np.int32))):
                    raise AssertionError(f"SegmentedCorpus.{m} ({stage}, k={k}) differs from "
                                         "the full scan of the alive rows")
                per_search[(m, k)] = counts["knn_scan+knn_merge<float32>"]
        ms = {(m, k): _median_ms(lambda: getattr(sc, m)(qs_host, k))
              for m, _ in modes for k in (10, 300)}
        log(f"[main] SegmentedCorpus ({stage}, {sc.num_segments} segments): knn_dot / knn / "
            f"knn_cosine at Q={n_q}, k=10 and 300, equal to batch_knn* over the alive rows bit "
            f"for bit; K1 launches per search {per_search}")
        log(f"[timing] SegmentedCorpus search ({stage}; CUDA events around the call, host copy "
            f"included, median of 7) ms: {ms}")
        return ms

    before = check("4% dead")
    t0 = time.perf_counter()
    sc.compact()
    torch.cuda.synchronize()
    compact_ms = (time.perf_counter() - t0) * 1e3
    log(f"[timing] SegmentedCorpus.compact (on the device, {sc.num_vectors} alive rows): "
        f"{compact_ms!r} ms")
    after = check("compacted")
    # npz round trip of a 100K-row corpus with tombstones.
    small = itt.SegmentedCorpus(128, device=dev)
    small.add(torch.randn((100_000, 128), generator=gen, device=dev).round_())
    small.add(torch.randn((1000, 128), generator=gen, device=dev).round_())
    small.delete(np.arange(0, 101_000, 7))  # 14% dead: below max_dead_frac
    path = ROOT / "build" / "chip_smoke_segmented.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    save_npz(str(path), small)
    back = load_npz(str(path), device=dev)
    npz_ms = (time.perf_counter() - t0) * 1e3
    path.unlink()
    for m, _ in modes:
        a, b = getattr(small, m)(qs_host, 10), getattr(back, m)(qs_host, 10)
        if not (np.array_equal(a[1], b[1]) and np.array_equal(a[0].view(np.int32),
                                                              b[0].view(np.int32))):
            raise AssertionError(f"SegmentedCorpus npz round trip changed {m}")
    if back.add(np.zeros((1, 128), np.float32)) != (101_000, 101_001):
        raise AssertionError("SegmentedCorpus npz round trip lost next_id")
    log(f"[timing] SegmentedCorpus npz round trip ({small.num_vectors} alive of 101000 rows, "
        f"save + load, host): {npz_ms!r} ms; searches equal after it")
    return sc, {"before": before, "after": after, "compact_ms": compact_ms}


def phase_segmented_clamp(dev, total: dict) -> None:
    """5c, near-copies: SegmentedCorpus over 10M x 100 unit rows (MSTuring's
    width) in 8 segments, 32 queries drawn from the rows, 24 near-copies of
    each planted at random positions (q + 3e-6 N(0, 1), renormalised), 4%
    of the ids deleted at random and a quarter of the copies besides. The
    copies' L2 keys differ, but about half of them decode to 0.0 once
    ||q||^2 is added back and clamped, so only K1's key order separates
    them. knn / knn_dot / knn_cosine at k = 10 and 100 must equal batch_knn*
    over the alive rows stacked in permanent-id order (ids mapped) bit for
    bit; the L2 answers must hold clamped ties."""
    import numpy as np
    import torch

    import innr_tpu_torch as itt

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    d, n_q, n_copies = 100, 32, 24
    n = N_SEGMENTS * SEGMENT_ROWS
    rows = torch.randn((n, d), generator=gen, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    picks = torch.randperm(n, generator=gen, device=dev)
    qs = rows[picks[:n_q]].clone()
    near = picks[n_q:n_q * (1 + n_copies)]
    copies = (qs.repeat_interleave(n_copies, 0)
              + 3e-6 * torch.randn((n_q * n_copies, d), generator=gen, device=dev))
    rows[near] = copies / copies.norm(dim=1, keepdim=True)
    del copies
    sc = itt.SegmentedCorpus(d, auto_compact=False, device=dev)
    for s in range(0, n, SEGMENT_ROWS):
        sc.add(rows[s:s + SEGMENT_ROWS])
    dead = np.union1d(torch.randperm(n, generator=gen, device=dev)[: n // 25].cpu().numpy(),
                      near[::4].cpu().numpy())
    n_dead = sc.delete(dead)
    if sc.num_segments != N_SEGMENTS or n_dead != len(dead):
        raise AssertionError("SegmentedCorpus compacted below its thresholds")
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[torch.as_tensor(dead, device=dev)] = False
    alive_ids = torch.nonzero(alive).squeeze(1).cpu().numpy()
    ref = itt.VerticalBatch(rows[alive])
    del rows, alive
    torch.cuda.empty_cache()
    qs_host = qs.cpu().numpy()
    clamped = {}
    for m, fn in (("knn", itt.batch_knn), ("knn_dot", itt.batch_knn_dot),
                  ("knn_cosine", itt.batch_knn_cosine)):
        for k in (10, 100):
            want = fn(qs, ref, k)
            (s, i), _ = _run_path(f"SegmentedCorpus.{m} (near-copies, k={k})",
                                  ["knn_scan+knn_merge<float32>"],
                                  lambda: getattr(sc, m)(qs_host, k), total)
            if not (np.array_equal(i, alive_ids[want.indices])
                    and np.array_equal(s.view(np.int32), want.scores.view(np.int32))):
                raise AssertionError(f"SegmentedCorpus.{m} (near-copies, k={k}) differs from "
                                     "the full scan of the alive rows")
            if m == "knn":
                clamped[k] = int((s == 0.0).sum(axis=1).min())
    if clamped[10] < 2:
        raise AssertionError(f"near-copies: some query has fewer than 2 clamped L2 scores "
                             f"in its top 10 ({clamped}); the case does not reach the clamp")
    log(f"[main] SegmentedCorpus near-copies ({n} x {d} unit rows in {N_SEGMENTS} segments, "
        f"{n_dead} deleted, {n_copies} copies of each of {n_q} queries): knn / knn_dot / "
        f"knn_cosine at k = 10 and 100 equal to batch_knn* over the alive rows bit for bit; "
        f"the fewest L2 scores clamped to 0.0 in a query's answer, by k: {clamped}")


def phase_serving(dev, sc, index, ivf_qs, total: dict) -> None:
    """5d: MicroBatcher over the compacted 10M x 128 SegmentedCorpus
    (knn_dot, k = 10). QPS of the batched call at b = 1, 8 and 32 (host
    clock, sequential calls); coalesced QPS with 96 client threads of
    single-query callers (max_batch 32, max_wait_ms 2, pipeline_depth 2),
    every answer equal to its query's row of one direct batched call bit for
    bit; the batch histogram; a 17-query window padded to 24 against 17
    unpadded (CUDA events); then one window through an IVFIndex backend."""
    import threading

    import numpy as np
    import torch

    import innr_tpu_torch as itt

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    k, n_pool = 10, 256
    pool = torch.randint(-4, 5, (n_pool, 128), generator=gen, device=dev).float().cpu().numpy()
    ref_s, ref_i = sc.knn_dot(pool, k)
    direct = {}
    for b in (1, 8, 32):
        calls = 40
        sc.knn_dot(pool[:b], k)
        t0 = time.perf_counter()
        for c in range(calls):
            s, i = sc.knn_dot(pool[(c * b) % n_pool:(c * b) % n_pool + b], k)
        direct[b] = b * calls / (time.perf_counter() - t0)
        at = ((calls - 1) * b) % n_pool
        if not (np.array_equal(i, ref_i[at:at + b])
                and np.array_equal(s.view(np.int32), ref_s[at:at + b].view(np.int32))):
            raise AssertionError(f"direct knn_dot at b={b} differs from the batched call")
    n_threads, per_thread = 96, 24
    n_req = n_threads * per_thread

    def coalesced(switch_s: float):
        """96 single-query client threads through a MicroBatcher, the
        interpreter's thread switch interval set to ``switch_s`` meanwhile;
        every answer held to the direct batched call. Returns (QPS, stats,
        launches)."""
        answers = [[] for _ in range(n_threads)]
        failures = []

        def client(t: int, mb):
            try:
                for j in range(per_thread):
                    q = (t * 37 + j * 11) % n_pool
                    answers[t].append((q, mb.search(pool[q], timeout=60.0)))
            except Exception as e:  # noqa: BLE001 — reported below
                failures.append(e)

        old_switch = sys.getswitchinterval()
        sys.setswitchinterval(switch_s)
        try:
            with itt.MicroBatcher(sc, k=k, max_batch=32, max_wait_ms=2.0,
                                  pipeline_depth=2) as mb:
                for q in range(4):  # warm-up
                    mb.search(pool[q], timeout=60.0)
                reset_counts()
                threads = [threading.Thread(target=client, args=(t, mb))
                           for t in range(n_threads)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300.0)
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                counts = read_counts()
                stats = mb.stats
        finally:
            sys.setswitchinterval(old_switch)
        if failures or any(t.is_alive() for t in threads):
            raise AssertionError(f"MicroBatcher clients failed: {failures[:3]}")
        _check_path("MicroBatcher over SegmentedCorpus", counts, ["knn_scan+knn_merge<float32>"])
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
        for rows in answers:
            for q, (s, i) in rows:
                if not (np.array_equal(i, ref_i[q])
                        and np.array_equal(s.view(np.int32), ref_s[q].view(np.int32))):
                    raise AssertionError(f"MicroBatcher answer for query {q} differs from the "
                                         "direct batched call")
        return n_req / wall, stats, counts

    qps, stats, counts = coalesced(sys.getswitchinterval())
    log(f"[main] MicroBatcher over SegmentedCorpus ({sc.num_vectors} x 128, knn_dot, k={k}): "
        f"{n_req} answers from {n_threads} client threads equal their rows of one direct "
        f"batched call bit for bit; {stats.launches - 4} windows of the clients' requests, "
        f"histogram (4 warm-up windows of 1 included) "
        f"{dict(sorted(stats.batch_histogram.items()))}, mean batch {stats.mean_batch!r}, "
        f"K1 launches {counts['knn_scan+knn_merge<float32>']}")
    log(f"[timing] serving QPS (host clock): direct knn_dot b=1 {direct[1]!r}, b=8 "
        f"{direct[8]!r}, b=32 {direct[32]!r}; coalesced, {n_threads} single-query clients "
        f"(max_batch 32, max_wait_ms 2, pipeline_depth 2): {qps!r} in "
        f"{stats.launches - 4} windows")
    # A diagnostic: the same load with the interpreter's thread switch
    # interval at 0.5 ms (the default is 5 ms), to see whether the client
    # threads' turns on the interpreter lock pace the windows.
    qps_fast, stats_fast, _ = coalesced(5e-4)
    log(f"[timing] serving QPS, coalesced, thread switch interval 0.5 ms: {qps_fast!r} in "
        f"{stats_fast.launches - 4} windows, mean batch {stats_fast.mean_batch!r}")
    q17 = pool[:17]
    q24 = np.concatenate([q17, np.repeat(q17[:1], 7, axis=0)])
    ms17 = _median_ms(lambda: sc.knn_dot(q17, k))
    ms24 = _median_ms(lambda: sc.knn_dot(q24, k))
    log(f"[timing] padding: knn_dot of a 17-query window {ms17!r} ms, padded to 24 (the bucket "
        f"ladder) {ms24!r} ms (CUDA events, host copy included, median of 7)")
    want = index.search_batch(ivf_qs, k)
    with itt.MicroBatcher(index, k=k, max_batch=8, max_wait_ms=50.0) as mb:
        futures = [mb.submit(q) for q in ivf_qs.cpu().numpy()]
        got = [f.result(timeout=60.0) for f in futures]
        windows = mb.stats.launches
    for j, (s, i) in enumerate(got):
        if not (np.array_equal(i, want.indices[j])
                and np.array_equal(s.view(np.int32), want.scores[j].view(np.int32))):
            raise AssertionError("MicroBatcher over IVFIndex differs from search_batch")
    log(f"[main] MicroBatcher over IVFIndex (search_batch): {len(got)} queries in {windows} "
        f"window(s), equal to search_batch bit for bit")


def _minhash_device(items, n_slots: int):
    """The host MinHash (``loader.minhash_sketch_host``) on the device in
    int64 arithmetic that wraps like the C runtime's uint64: per document
    and slot, the least high word of splitmix64(item + (slot + 1) *
    0x9E3779B97F4A7C15). ``items``: (docs, m) int64. Returns (docs, slots)
    int64 in [0, 2^32)."""
    import torch

    def signed(c: int) -> int:
        return c - (1 << 64) if c >= 1 << 63 else c

    def shr(x, s: int):
        return (x >> s) & ((1 << (64 - s)) - 1)

    seeds = torch.tensor([signed((s + 1) * 0x9E3779B97F4A7C15 % (1 << 64))
                          for s in range(n_slots)], dtype=torch.int64, device=items.device)
    out = torch.empty((items.shape[0], n_slots), dtype=torch.int64, device=items.device)
    for a in range(0, items.shape[0], 8192):
        x = items[a:a + 8192, :, None] + seeds
        x = (x ^ shr(x, 30)) * signed(0xBF58476D1CE4E5B9)
        x = (x ^ shr(x, 27)) * signed(0x94D049BB133111EB)
        x = x ^ shr(x, 31)
        out[a:a + 8192] = shr(x, 32).amin(dim=1)
    return out


def phase_loader(dev) -> None:
    """5e: the host encoders at 1M x 768 f32 (binary at 0, ternary at 0.5,
    u8 over [-4, 4]) against the port's on-device encoders bit for bit,
    host ms (the C runtime's threads, the upload of the packed result
    included) beside device ms (CUDA events); MinHash of 100K documents of
    64 shingles into 128 slots against the same hashes in int64 on the
    device."""
    import numpy as np
    import torch

    import innr_tpu_torch as itt
    from innr_tpu_torch import _native, loader

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    rows = torch.randn((N_LOADER, 768), generator=gen, device=dev)
    host = rows.cpu().numpy()
    params = itt.QuantizationParams.from_range(-4.0, 4.0)

    def planes_of(batch):
        return batch.pos, batch.neg

    cases = (
        ("encode_binary_host", lambda: loader.encode_binary_host(host, 0.0, device=dev).words,
         lambda: itt.encode_binary_batch(rows, 0.0)),
        ("encode_ternary_host",
         lambda: torch.stack(planes_of(loader.encode_ternary_host(host, 0.5, device=dev))),
         lambda: torch.stack(itt.encode_ternary_batch(rows, 0.5))),
        ("quantize_u8_host", lambda: loader.quantize_u8_host(host, params, device=dev).codes,
         lambda: itt.QuantizedU8Batch.quantize(rows, params).codes),
    )
    native = _native.available()
    for name, on_host, on_device in cases:
        if not torch.equal(on_host(), on_device()):
            raise AssertionError(f"{name} {N_LOADER} x 768 differs from the device encoder")
        host_ms = _median_host_ms(lambda: (on_host(), torch.cuda.synchronize()), reps=3)
        dev_ms = _median_ms(on_device, reps=5)
        log(f"[timing] {name} {N_LOADER} x 768: equal to the device encoder bit for bit; host "
            f"{host_ms!r} ms ({'C runtime' if native else 'numpy'}, upload included, median of "
            f"3), device {dev_ms!r} ms")
    del rows, host
    halves = torch.randint(-(2**31), 2**31, (2, N_MINHASH_DOCS, 64), generator=gen, device=dev,
                           dtype=torch.int64)
    items = (halves[0] << 32) | (halves[1] & 0xFFFFFFFF)  # all 64 bits
    docs = items.cpu().numpy().view(np.uint64)
    got = loader.minhash_sketch_host(docs, 128)
    want = _minhash_device(items, 128)
    if not torch.equal(torch.from_numpy(got.astype(np.int64)).to(dev), want):
        raise AssertionError("minhash_sketch_host differs from the device hashes")
    host_ms = _median_host_ms(lambda: loader.minhash_sketch_host(docs, 128), reps=3)
    dev_ms = _median_ms(lambda: _minhash_device(items, 128), reps=3)
    log(f"[timing] minhash_sketch_host {N_MINHASH_DOCS} docs x 64 shingles, 128 slots: equal to the device "
        f"hashes; host {host_ms!r} ms ({'C runtime' if native else 'numpy'}), device (int64 "
        f"torch, this script's twin) {dev_ms!r} ms")


# -- phase 6 ---------------------------------------------------------------

def _host_pair(res):
    """A result as a pair of numpy arrays: ``(scores, indices)`` of a
    BatchKnnResult, or a pair of tensors / arrays."""
    import numpy as np
    import torch

    if hasattr(res, "indices"):
        res = (res.scores, res.indices)
    return tuple(np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in res)


def _same_pair(name: str, got, want) -> None:
    """Two results equal: float scores bit for bit, integers exactly."""
    import numpy as np

    for g, w in zip(_host_pair(got), _host_pair(want), strict=True):
        if g.dtype.kind == "f":
            g, w = g.astype(np.float32).view(np.int32), w.astype(np.float32).view(np.int32)
        else:
            g, w = g.astype(np.int64), w.astype(np.int64)
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{name}: differs from the single-card call")


def _sharded_time(name: str, sharded, single, times: dict) -> None:
    """CUDA-event medians of a sharded call and its single-card counterpart
    (each followed by the host copy of its result), logged with the ratio;
    the pair goes into ``times`` under ``name``."""
    s_ms = _median_ms(lambda: _host_pair(sharded()))
    o_ms = _median_ms(lambda: _host_pair(single()))
    times[name] = (s_ms, o_ms)
    log(f"[timing] sharded {name}: {s_ms!r} ms, single-card {o_ms!r} ms, ratio "
        f"{s_ms / o_ms!r} (CUDA events, host copy included, median of 7)")


def _sharded_dense(dev, meshes, total: dict, times: dict) -> None:
    """6a: f32 10M x 128 through ShardedCorpus (dot, l2, cosine, filtered,
    a (D,) query), QueryParallelIndex, GridIndex 2 x 2, HierarchicalCorpus 2
    x 2, a MicroBatcher in front of the 4-shard corpus and a one-rank NCCL
    group's corpus_from_process_local_rows; sharded_overhead_1dev at 2M and
    10M, the 4-shard call and the merge alone."""
    import tempfile
    import threading

    import torch
    import torch.distributed as dist

    import innr_tpu_torch as itt
    import innr_tpu_torch.parallel as par
    from innr_tpu_torch.kernels import knn as tk
    from innr_tpu_torch.parallel import multihost
    from innr_tpu_torch.parallel.sharded import _local_keys
    from innr_tpu_torch.utils.order import merge_parts

    m1, m4 = meshes.values()
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    n, n_q, k = N_SHARDED, 32, 10
    rows = torch.randn((n, 128), generator=gen, device=dev)
    qs = torch.randn((n_q, 128), generator=gen, device=dev)
    mask = (torch.rand(n, generator=gen, device=dev) < 0.3).cpu().numpy()
    vb = itt.VerticalBatch(rows)
    full = {"knn_dot": itt.batch_knn_dot, "knn_l2": itt.batch_knn,
            "knn_cosine": itt.batch_knn_cosine}
    want = {m: fn(qs, vb, k) for m, fn in full.items()}
    want["knn_filtered"] = itt.batch_knn_filtered(qs, vb, k, mask)
    k1 = ["knn_scan+knn_merge<float32>"]

    def check_dense(label: str, index, methods) -> None:
        got, _ = _run_path(label, k1, lambda: {
            m: (index.knn_filtered(qs, k, mask) if m == "knn_filtered"
                else getattr(index, m)(qs, k)) for m in methods}, total)
        for m in methods:
            _same_pair(f"{label} {m}", got[m], want[m])
        log(f"[main] {label} ({n} x 128 f32, Q={n_q}, k={k}): {', '.join(methods)} equal the "
            "single-card calls bit for bit")

    all4 = ("knn_dot", "knn_l2", "knn_cosine", "knn_filtered")
    for label, mesh in meshes.items():
        sc = par.ShardedCorpus(rows, mesh)
        check_dense(f"ShardedCorpus {label}", sc, all4)
        got, _ = _run_path(f"ShardedCorpus {label} (D,)", k1, lambda: sc.knn_l2(qs[3], k), total)
        _same_pair(f"ShardedCorpus {label} (D,)", got, itt.batch_knn(qs[3], vb, k))
    four = [dev] * 4
    check_dense("QueryParallelIndex [cuda:0] x 4", par.QueryParallelIndex(rows, m4),
                all4)
    check_dense("GridIndex 2 x 2", par.GridIndex(rows, par.grid_mesh(2, 2, four)), all4)
    check_dense("HierarchicalCorpus 2 x 2",
                par.HierarchicalCorpus(rows, par.hierarchical_mesh(2, 2, four)), all4[:3])

    # MicroBatcher in front of the 4-shard corpus (its knn_dot backend).
    sc4 = par.ShardedCorpus(rows, m4)
    pool = torch.randn((64, 128), generator=gen, device=dev).cpu().numpy()
    ref_s, ref_i = _host_pair(itt.batch_knn_dot(pool, vb, k))
    answers, failures = [], []

    def client(t: int, mb) -> None:
        try:
            for j in range(4):
                q = t * 4 + j
                answers.append((q, mb.search(pool[q], timeout=60.0)))
        except Exception as e:  # noqa: BLE001 — reported below
            failures.append(e)

    def serve():
        with itt.MicroBatcher(sc4, k=k, max_batch=32, max_wait_ms=2.0) as mb:
            threads = [threading.Thread(target=client, args=(t, mb)) for t in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            return mb.stats

    stats, _ = _run_path("MicroBatcher over ShardedCorpus", k1, serve, total)
    if failures or len(answers) != 64:
        raise AssertionError(f"MicroBatcher over ShardedCorpus: clients failed {failures[:3]}")
    for q, (s, i) in answers:
        _same_pair(f"MicroBatcher over ShardedCorpus query {q}", (s, i), (ref_s[q], ref_i[q]))
    log(f"[main] MicroBatcher over ShardedCorpus [cuda:0] x 4 (knn_dot, k={k}): 64 answers "
        f"from 16 client threads equal batch_knn_dot bit for bit, {stats.launches} windows")

    # One-rank NCCL group: the process corpus gathers through the group.
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize(f"file://{tmp}/rdv", 1, 0)
        try:
            if dev.type == "cuda" and dist.get_backend() != "nccl":
                raise AssertionError(f"multihost on the card took {dist.get_backend()}")
            pc = multihost.corpus_from_process_local_rows(rows, mesh=m4)
            check_dense("corpus_from_process_local_rows (one-rank NCCL group, 4 shards)", pc,
                        all4)
        finally:
            dist.destroy_process_group()

    # Timing: one-card and 4-shard calls against batch_knn_dot, the merge.
    for rows_n in (N_OVERHEAD, n):
        sub = rows[:rows_n]
        vb_n = itt.VerticalBatch(sub)
        sc1 = par.ShardedCorpus(sub, m1)
        sc4 = par.ShardedCorpus(sub, m4)
        tag = f"{rows_n / 1e6:g}M"
        _sharded_time(f"knn_dot [cuda:0] {tag}", lambda: sc1.knn_dot(qs, k),
                      lambda: itt.batch_knn_dot(qs, vb_n, k), times)
        _sharded_time(f"knn_dot [cuda:0] x 4 {tag}", lambda: sc4.knn_dot(qs, k),
                      lambda: itt.batch_knn_dot(qs, vb_n, k), times)
        dev1 = _median_ms(lambda: sc1.knn_dot(qs, k))
        dev0 = _median_ms(lambda: tk.fused_knn_dot_batch(qs, sub, k))
        log(f"[timing] sharded_overhead_1dev {tag} x 128 (Q={n_q}, k={k}): "
            f"{times[f'knn_dot [cuda:0] {tag}'][0] / times[f'knn_dot [cuda:0] {tag}'][1]!r} "
            f"with the host copies; on the device {dev1!r} ms against K1's "
            f"fused_knn_dot_batch {dev0!r} ms, ratio {dev1 / dev0!r}")
    parts = [_local_keys(sc4, i, qs, k, "dot", False) for i in range(4)]
    merge_ms = _median_ms(lambda: merge_parts(parts, k, dev))
    times["merge"] = (merge_ms, None)
    log(f"[timing] the merge alone (4 shards' (32, {k}) candidates: composites, copy, topk): "
        f"{merge_ms!r} ms")
    del rows, vb, sc4, pc, parts
    torch.cuda.empty_cache()


def _sharded_bf16_prune_u8(dev, meshes, total: dict, times: dict) -> None:
    """6b: bf16 20M x 128 (dot, l2, cosine, filtered); prune=True on the
    clustered, cluster-ordered 10M x 128 corpus over 4 shards (no K1
    launch); u8 1M x 768 ShardedQuantizedU8."""
    import torch

    import innr_tpu_torch as itt
    import innr_tpu_torch.parallel as par

    m1, m4 = meshes.values()
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    n_q, k = 32, 10
    qs = torch.randn((n_q, 128), generator=gen, device=dev)
    bf16 = torch.empty((2 * N_SHARDED, 128), dtype=torch.bfloat16, device=dev)
    for s in range(0, bf16.shape[0], 1 << 20):
        bf16[s:s + (1 << 20)] = torch.randn((min(1 << 20, bf16.shape[0] - s), 128),
                                            generator=gen, device=dev)
    mask = (torch.rand(bf16.shape[0], generator=gen, device=dev) < 0.3).cpu().numpy()
    vb = itt.VerticalBatch(bf16, dtype=torch.bfloat16)
    full = {"knn_dot": itt.batch_knn_dot, "knn_l2": itt.batch_knn,
            "knn_cosine": itt.batch_knn_cosine}
    want = {m: fn(qs, vb, k) for m, fn in full.items()}
    want["knn_filtered"] = itt.batch_knn_filtered(qs, vb, k, mask)
    for label, mesh in meshes.items():
        sc = par.ShardedCorpus(bf16, mesh, dtype=torch.bfloat16)
        got, _ = _run_path(f"ShardedCorpus bf16 {label}", ["knn_scan+knn_merge<bfloat16>"],
                           lambda: {m: (sc.knn_filtered(qs, k, mask) if m == "knn_filtered"
                                        else getattr(sc, m)(qs, k)) for m in want}, total)
        for m in want:
            _same_pair(f"ShardedCorpus bf16 {label} {m}", got[m], want[m])
    log(f"[main] ShardedCorpus bf16 {bf16.shape[0]} x 128 on [cuda:0] and [cuda:0] x 4: dot, "
        "l2, cosine, "
        "filtered equal the single-card calls bit for bit")
    _sharded_time(f"knn_dot bf16 [cuda:0] x 4 {bf16.shape[0] / 1e6:g}M", lambda: sc.knn_dot(qs, k),
                  lambda: itt.batch_knn_dot(qs, vb, k), times)
    del bf16, vb, sc
    torch.cuda.empty_cache()

    rows, centers = _clustered(gen, N_PRUNE, 256, True, dev)
    qs = centers[:n_q] + 0.01 * torch.randn((n_q, 128), generator=gen, device=dev)
    vb = itt.VerticalBatch(rows)
    want = {m: fn(qs, vb, k) for m, fn in full.items()}
    sc = par.ShardedCorpus(rows, m4)
    for s in (False, True):
        sc.tile_summary(normalized=s)
    torch.cuda.synchronize()
    got, counts = _run_path("ShardedCorpus prune=True [cuda:0] x 4",
                            ["knn_scan_tiles+knn_merge<float32>"],
                            lambda: {m: getattr(sc, m)(qs, k, prune=True) for m in want}, total)
    if launches_of(counts, "knn_scan+knn_merge"):
        raise AssertionError("ShardedCorpus prune=True launched K1's full scan")
    for m in want:
        _same_pair(f"ShardedCorpus prune=True {m}", got[m], want[m])
    log(f"[main] ShardedCorpus prune=True on the clustered {N_PRUNE} x 128 corpus, 4 shards "
        f"(per-shard tile summaries of {sc.tile_summary()[0].tile_n} rows): dot, l2, cosine "
        "equal the single-card full scan bit for bit, with no K1 launch")
    vb.tile_summary()
    _sharded_time(f"knn_dot prune=True clustered [cuda:0] x 4 {N_PRUNE / 1e6:g}M",
                  lambda: sc.knn_dot(qs, k, prune=True),
                  lambda: itt.batch_knn_dot(qs, vb, k, prune=True), times)
    del rows, vb, sc
    torch.cuda.empty_cache()

    codes = torch.randint(0, 256, (N_SHARDED_U8, 768), generator=gen, device=dev,
                          dtype=torch.uint8)
    qs = torch.randn((n_q, 768), generator=gen, device=dev)
    params = itt.QuantizationParams.from_range(-1.0, 1.0)
    want = itt.batch_knn_u8_multi(qs, itt.QuantizedU8Batch(codes), params, k)
    for label, mesh in meshes.items():
        sq = par.ShardedQuantizedU8(codes, params, mesh)
        got, _ = _run_path(f"ShardedQuantizedU8 {label}", ["knn_scan+knn_merge<uint8>"],
                           lambda: sq.knn(qs, k), total)
        _same_pair(f"ShardedQuantizedU8 {label}", got, want)
    log(f"[main] ShardedQuantizedU8 {N_SHARDED_U8} x 768 on [cuda:0] and [cuda:0] x 4 equals "
        "batch_knn_u8_multi bit for bit")
    u8 = itt.QuantizedU8Batch(codes)
    _sharded_time(f"ShardedQuantizedU8 [cuda:0] x 4 {N_SHARDED_U8 / 1e6:g}M x 768",
                  lambda: sq.knn(qs, k), lambda: itt.batch_knn_u8_multi(qs, u8, params, k),
                  times)
    del codes, sq, u8
    torch.cuda.empty_cache()


def _sharded_integer_families(dev, meshes, total: dict, times: dict) -> None:
    """6c: packed binary 30M x 768 bits and ternary 15M x 768 (Q=16), slot
    sketches 10M x 128 in u32 and u16 (knn_batch, knn, minhash_knn), sparse
    10M x 32 (Q=16)."""
    import torch

    import innr_tpu_torch as itt
    import innr_tpu_torch.parallel as par
    from innr_tpu_torch.ops.binary import binary_knn_batch
    from innr_tpu_torch.ops.ternary import ternary_knn_batch

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    d, w, n_q, k = 768, 24, 16, 10
    wb = words(gen, (3 * N_SHARDED, w), dev)
    (qb,) = planes(gen, "binary", (n_q, w), dev)
    bb = itt.PackedBinaryBatch(wb, d)
    want = binary_knn_batch(qb, bb, k)
    want1 = itt.binary_knn(itt.PackedBinary(qb[0], d), bb, k)
    for label, mesh in meshes.items():
        sb = par.ShardedPackedBinary(wb, d, mesh)
        got, _ = _run_path(f"ShardedPackedBinary {label}", ["packed_scan<binary>"],
                           lambda: (sb.knn_batch(qb, k), sb.knn(itt.PackedBinary(qb[0], d), k)),
                           total)
        _same_pair(f"ShardedPackedBinary {label} knn_batch", got[0], want)
        _same_pair(f"ShardedPackedBinary {label} knn", got[1], want1)
    _sharded_time(f"ShardedPackedBinary [cuda:0] x 4 {3 * N_SHARDED / 1e6:g}M x 768 bits Q=16",
                  lambda: sb.knn_batch(qb, k), lambda: binary_knn_batch(qb, bb, k), times)
    del wb, bb, sb
    torch.cuda.empty_cache()
    pos, neg = planes(gen, "ternary", (3 * N_SHARDED // 2, w), dev)
    qtp, qtn = planes(gen, "ternary", (n_q, w), dev)
    tb = itt.PackedTernaryBatch(pos, neg, d)
    want = ternary_knn_batch((qtp, qtn), tb, k)
    for label, mesh in meshes.items():
        st = par.ShardedPackedTernary(pos, neg, d, mesh)
        got, _ = _run_path(f"ShardedPackedTernary {label}", ["packed_scan<ternary>"],
                           lambda: st.knn_batch((qtp, qtn), k), total)
        _same_pair(f"ShardedPackedTernary {label}", got, want)
    _sharded_time(f"ShardedPackedTernary [cuda:0] x 4 {1.5 * N_SHARDED / 1e6:g}M x 768 Q=16",
                  lambda: st.knn_batch((qtp, qtn), k),
                  lambda: ternary_knn_batch((qtp, qtn), tb, k), times)
    log(f"[main] ShardedPackedBinary {3 * N_SHARDED} x 768 bits (knn_batch Q=16, knn) and "
        f"ShardedPackedTernary {3 * N_SHARDED // 2} x 768 on [cuda:0] and [cuda:0] x 4 equal "
        "the single-card "
        "calls exactly")
    del pos, neg, tb, st
    torch.cuda.empty_cache()

    for dtype, bits in ((torch.int32, 32), (torch.int16, 16)):
        sk = _random_slots(gen, N_SKETCH, SLOTS, dtype, dev)
        pick = torch.randint(0, N_SKETCH, (n_q,), generator=gen, device=dev)
        qs = sk[pick].clone()
        qs[:, :SLOTS // 4] = _random_slots(gen, n_q, SLOTS // 4, dtype, dev)
        corpus = itt.SketchCorpus(sk)
        single = itt.slot_knn_u32_batch if bits == 32 else itt.slot_knn_u16_batch
        want = (single(qs, corpus, k), itt.minhash_knn(qs[0], corpus, k))
        for label, mesh in meshes.items():
            ss = par.ShardedSlotCorpus(sk, mesh)
            got, _ = _run_path(f"ShardedSlotCorpus u{bits} {label}", [f"slot_scan<uint{bits}>"],
                               lambda: (ss.knn_batch(qs, k), ss.minhash_knn(qs[0], k)), total)
            _same_pair(f"ShardedSlotCorpus u{bits} {label} knn_batch", got[0], want[0])
            _same_pair(f"ShardedSlotCorpus u{bits} {label} minhash_knn", got[1], want[1])
        _sharded_time(f"ShardedSlotCorpus u{bits} [cuda:0] x 4 {N_SKETCH / 1e6:g}M x 128 Q=16",
                      lambda: ss.knn_batch(qs, k), lambda: single(qs, corpus, k), times)
        del sk, corpus, ss
        torch.cuda.empty_cache()
    log(f"[main] ShardedSlotCorpus {N_SKETCH} x {SLOTS} u32 and u16 (knn_batch Q=16, "
        "minhash_knn) on "
        "[cuda:0] and [cuda:0] x 4 equal the single-card calls exactly")

    p = 1.0 / torch.arange(1, VOCAB + 1, dtype=torch.float64, device=dev)
    cdf = (torch.cumsum(p, 0) / p.sum()).float()
    perm = torch.randperm(VOCAB, generator=gen, device=dev).to(torch.int32)
    ids, vals = _zipf_sparse_corpus(gen, dev, perm, cdf)
    q_ids = torch.stack([perm[torch.randperm(VOCAB, generator=gen, device=dev)[:QUERY_NNZ]]
                         for _ in range(n_q)])
    q_idx, _ = unsigned_sort(q_ids, 1)
    q_val = torch.rand((n_q, QUERY_NNZ), generator=gen, device=dev)
    corpus = itt.SparseCorpus((ids, vals))
    want = itt.sparse_knn_batch((q_idx, q_val), corpus, k)
    for label, mesh in meshes.items():
        sp = par.ShardedSparseCorpus((ids, vals), mesh)
        got, _ = _run_path(f"ShardedSparseCorpus {label}", ["sparse_scan"],
                           lambda: sp.knn_batch((q_idx, q_val), k), total)
        _same_pair(f"ShardedSparseCorpus {label}", got, want)
    log(f"[main] ShardedSparseCorpus {N_SPARSE} x {ENTRIES} (Zipf WordPiece ids, Q={n_q}, "
        f"Lq={QUERY_NNZ}) on [cuda:0] and [cuda:0] x 4 equals sparse_knn_batch bit for bit")
    _sharded_time(f"ShardedSparseCorpus [cuda:0] x 4 {N_SPARSE / 1e6:g}M x 32 Q={n_q}",
                  lambda: sp.knn_batch((q_idx, q_val), k),
                  lambda: itt.sparse_knn_batch((q_idx, q_val), corpus, k), times)
    del ids, vals, corpus, sp
    torch.cuda.empty_cache()


def _sharded_maxsim_two_stage(dev, meshes, total: dict, times: dict) -> None:
    """6d: ShardedMaxSimCorpus over 200K x 180 x 128 f32 documents with
    their mask (B=16); ShardedTwoStageIndex over 1M x 768 in all four
    coarse kinds (one card: equal to TwoStageIndex; 4 shards: equal to the
    merge of the single-card index over each shard's rows)."""
    import torch

    import innr_tpu_torch as itt
    import innr_tpu_torch.parallel as par
    from innr_tpu_torch.utils.order import top_k_total

    m1, m4 = meshes.values()
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    k, n_b = 10, 16
    docs, mask, lengths = _colbert_corpus(gen, dev)
    planted = torch.arange(n_b, device=dev) * (N_MAXSIM // n_b)
    pick = (torch.rand((n_b, MAXSIM_TQ), generator=gen, device=dev)
            * lengths[planted, None]).long()
    qs = docs[planted[:, None], pick] + 0.1 * torch.randn((n_b, MAXSIM_TQ, MAXSIM_D),
                                                          generator=gen, device=dev)
    qs = qs / qs.norm(dim=2, keepdim=True)
    want = itt.maxsim_knn_batch(qs, docs, k, doc_mask=mask)
    for label, mesh in meshes.items():
        sm = par.ShardedMaxSimCorpus(docs, mask, mesh)
        got, _ = _run_path(f"ShardedMaxSimCorpus {label}", ["maxsim_scores<float32>"],
                           lambda: sm.knn(qs, k), total)
        _same_pair(f"ShardedMaxSimCorpus {label}", got, want)
    log(f"[main] ShardedMaxSimCorpus {N_MAXSIM} x {MAXSIM_TD} x {MAXSIM_D} f32 (B={n_b}) on "
        "[cuda:0] and [cuda:0] x 4 equals maxsim_knn_batch bit for bit")
    _sharded_time(f"ShardedMaxSimCorpus [cuda:0] x 4 B={n_b}", lambda: sm.knn(qs, k),
                  lambda: itt.maxsim_knn_batch(qs, docs, k, doc_mask=mask), times)
    del docs, mask, sm
    torch.cuda.empty_cache()

    n, d, n_q = N_SHARDED_U8, 768, 32
    rows = torch.randn((n, d), generator=gen, device=dev)
    qs = torch.randn((n_q, d), generator=gen, device=dev)
    kinds = (("binary", itt.CoarseConfig("binary"), 64, "packed_scan<binary>"),
             ("ternary", itt.CoarseConfig("ternary"), 64, "packed_scan<ternary>"),
             ("u8", itt.CoarseConfig("u8"), 8, "knn_scan+knn_merge<uint8>"),
             ("matryoshka", itt.CoarseConfig("matryoshka", prefix_dims=128), 10,
              "knn_scan+knn_merge<float32>"))
    for kind, cfg, rf, kernel in kinds:
        single = itt.TwoStageIndex(rows, cfg, rerank_factor=rf)
        # The 4-shard reference: the single-card index over each shard's
        # rows (u8 with the whole corpus's parameters), merged by score.
        s4 = par.ShardedTwoStageIndex(rows, cfg, rf, m4)
        parts = []
        for (a, b) in s4.ranges:
            part = itt.TwoStageIndex(rows[a:b], cfg, rerank_factor=rf)
            if kind == "u8":
                part.params = s4.params
                part._coarse = itt.QuantizedU8Batch.quantize(rows[a:b], s4.params)
            res = part.search_batch(qs, k)
            parts.append((torch.as_tensor(res.scores), torch.as_tensor(res.indices) + a))
        vals, pos = top_k_total(torch.cat([p[0] for p in parts], 1), k)
        want4 = (vals, torch.gather(torch.cat([p[1] for p in parts], 1), 1, pos))
        for label, mesh, want in (("[cuda:0]", m1, single.search_batch(qs, k)),
                                  ("[cuda:0] x 4", m4, want4)):
            st = par.ShardedTwoStageIndex(rows, cfg, rf, mesh)
            got, _ = _run_path(f"ShardedTwoStageIndex {kind} {label}", [kernel],
                               lambda: st.search_batch(qs, k), total)
            _same_pair(f"ShardedTwoStageIndex {kind} {label}", got, want)
        _sharded_time(f"ShardedTwoStageIndex {kind} [cuda:0] x 4 {n / 1e6:g}M x 768",
                      lambda: st.search_batch(qs, k), lambda: single.search_batch(qs, k), times)
        del single, s4, st
    log(f"[main] ShardedTwoStageIndex {n} x 768 (binary, ternary, u8, matryoshka; Q=32, k=10): "
        "one card equals TwoStageIndex bit for bit, 4 shards the single-card index over each "
        "shard's rows merged by score")
    del rows
    torch.cuda.empty_cache()


def phase_sharded(dev, total: dict) -> dict:
    """6: the sharded family (innr_tpu_torch.parallel) on one card, every
    container on a one-card mesh and a mesh of four shards on the same card,
    each path with the counters reset just before it and read just after,
    held to the single-card call over the same rows bit for bit. Returns the
    timings by name."""
    import innr_tpu_torch.parallel as par

    meshes = {"[cuda:0]": par.default_mesh([dev]), "[cuda:0] x 4": par.default_mesh([dev] * 4)}
    times = {}
    t0 = time.perf_counter()
    for part in (_sharded_dense, _sharded_bf16_prune_u8, _sharded_integer_families,
                 _sharded_maxsim_two_stage):
        part(dev, meshes, total, times)
    log(f"[main] phase 6 (sharded) took {time.perf_counter() - t0!r} s of host time")
    return times


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
    phase_exact_pruned(dev)
    phase_exact_tc(dev)
    phase_exact_wide(dev)
    phase_exact_slot_sparse(dev)
    phase_exact_maxsim(dev)
    corpora, errs, bounds = {}, {}, {}
    launches = phase_main(dev, corpora, errs)
    _check_path("batch-kNN", launches,
                [f"knn_scan+knn_merge<{name}>" for name in ("float32", "bfloat16", "uint8")])
    times = {f"knn_scan+knn_merge<{name}>": t
             for name, t in phase_timing(corpora, bounds).items()}
    full_ms = times["knn_scan+knn_merge<float32>"][0]
    phase_wide(dev)
    gauss_launches, _ = phase_gaussian_prune(dev, corpora, full_ms)
    corpora.clear()
    torch.cuda.empty_cache()
    packed_launches, packed_times, packed_errs = phase_packed(dev, bounds)
    times.update(packed_times)
    torch.cuda.empty_cache()
    pipeline_launches = phase_pipeline(dev, errs)
    torch.cuda.empty_cache()
    prune_errs = {}
    library = {}
    prune_launches, prune_times = phase_prune(dev, full_ms, prune_errs, bounds, library)
    times.update(prune_times)
    torch.cuda.empty_cache()
    slot_launches, slot_times = phase_slot(dev, prune_errs, bounds)
    times.update(slot_times)
    torch.cuda.empty_cache()
    sparse_launches, sparse_times = phase_sparse(dev, prune_errs, bounds)
    times.update(sparse_times)
    torch.cuda.empty_cache()
    maxsim_launches, maxsim_times = phase_maxsim(dev, prune_errs, bounds)
    times.update(maxsim_times)
    torch.cuda.empty_cache()
    slice_launches = {}
    ivf, ivf_qs = phase_ties(dev, slice_launches)
    phase_sparse_long(dev, slice_launches)
    segmented, _ = phase_segmented(dev, slice_launches)
    phase_segmented_clamp(dev, slice_launches)
    phase_serving(dev, segmented, ivf, ivf_qs, slice_launches)
    del segmented, ivf
    torch.cuda.empty_cache()
    phase_loader(dev)
    torch.cuda.empty_cache()
    sharded_launches = {}
    phase_sharded(dev, sharded_launches)
    log(f"[main] kernel passes on the sharded paths: {sharded_launches}")
    for counts in (gauss_launches, packed_launches, pipeline_launches, prune_launches,
                   slot_launches, sparse_launches, maxsim_launches, slice_launches,
                   sharded_launches):
        for name, n in counts.items():
            launches[name] += n
    for name in prune_times:
        launches[name] = launches_of(launches, name)
    errs = ({f"knn_scan+knn_merge<{name}>": err for name, err in errs.items()} | packed_errs
            | prune_errs)
    kernels = [
        ("knn_scan+knn_merge<float32>", "knn.cu", "kernels/knn.py:197"),
        ("knn_scan+knn_merge<bfloat16>", "knn.cu", "kernels/knn.py:197"),
        ("knn_scan+knn_merge<uint8>", "knn.cu", "kernels/knn.py:197"),
        ("packed_scan<binary>", "packed_knn.cu", "kernels/packed_knn.py:93,150"),
        ("packed_scan<ternary>", "packed_knn.cu", "kernels/packed_knn.py:228,292"),
        ("packed_rows<binary>", "packed.cu", "kernels/hamming.py:32"),
        ("packed_rows<ternary>", "packed.cu", "kernels/hamming.py:62"),
        ("knn_scan_tiles+knn_merge", "knn.cu", "kernels/pruned_knn.py:80,162"),
        ("threshold_scan", "pruned.cu", "kernels/pruned_knn.py:483,566"),
        ("threshold_compact", "pruned.cu", "kernels/pruned_knn.py:483,566"),
        # No TPU kernel: the JAX plan's elementwise steps and partition,
        # fused into one launch.
        ("threshold_plan", "pruned.cu", "prune.py:255"),
        ("nearest_centroid", "assign.cu", "kernels/assign.py:71"),
        ("slot_scan<uint32>", "slot_knn.cu", "kernels/slot_knn.py:83,145"),
        ("slot_scan<uint16>", "slot_knn.cu", "kernels/slot_knn.py:83,145"),
        ("sparse_scan", "sparse_knn.cu", "kernels/sparse_knn.py:73"),
        ("maxsim_scores<float32>", "maxsim.cu", "kernels/maxsim_kernel.py:41,166"),
        ("maxsim_scores<bfloat16>", "maxsim_bf16.cu", "kernels/maxsim_kernel.py:41,166"),
    ]
    # No single PyTorch call computes the other functions: the scans need a
    # product (or a count) and a selection, torch has no popcount, and
    # MaxSim needs a product, a masked max and a sum. Over every tile the
    # dense threshold scan is one torch.addmv, which phase 4 times beside
    # it; the compacted form adds a selection (no single call).
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"innr_tpu_torch/csrc/{source}",
            "replaces": f"innr_tpu/{replaces}",
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": library.get(name),
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
