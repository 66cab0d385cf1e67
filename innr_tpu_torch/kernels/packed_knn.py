"""Fused packed-corpus kNN: the CUDA kernel and its plain version.

Replaces the TPU kernels of ``innr_tpu/kernels/packed_knn.py``:
``_binary_kernel`` / ``_binary_kernel_mq`` (the k smallest XOR-popcount
counts) and ``_ternary_kernel`` / ``_ternary_kernel_mq`` (the k largest
ternary dots), for one query or a batch. The kernel is
``csrc/packed_knn.cu`` (``packed_scan``, then ``knn_merge`` from
``csrc/knn.cu``); its source note says what bounds it on the H100.

The corpus is word-major, ``(W, N)`` int32 planes, the JAX package's cached
transpose (``PackedBinaryBatch.words_t``): word w of neighbouring rows is
contiguous, so a warp's loads are coalesced. Words are the JAX package's
``uint32`` words held as bit-identical int32
(:mod:`innr_tpu_torch.utils.bits`).

Selection runs on the int64 composites of K1 (:mod:`.knn`): the key is
``-count`` for binary and the dot for ternary, larger is better, ties go
to the lower row. Any k runs through K1's exclusion-bounded multi-pass
driver (:func:`.knn._multi_pass`) in passes of at most
:func:`.knn.single_pass_k`; the JAX package hands k above its cap to
``jax.lax.top_k`` instead, which selects the same rows.

Dispatch: a CUDA tensor runs the kernel, or the call raises; a CPU tensor,
or :func:`innr_tpu_torch.config.force_reference`, runs the plain version.
"""

from __future__ import annotations

import torch

from innr_tpu_torch import config
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.kernels import row_scan
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import word_scores
from innr_tpu_torch.utils.order import composite_keys, split_composite

# int32 elements per intermediate of the plain version, which runs over
# corpus rows in chunks of this size with a running top-k.
_PLAIN_CHUNK = 1 << 25

# Kernel passes launched (each pass launches packed_scan, then knn_merge),
# in all and by kind. Incremented only where the kernels launch.
LAUNCHES = 0
LAUNCHES_BY_KIND = {"binary": 0, "ternary": 0}


def _check(queries, planes_t, k: int, op: str):
    """Contiguous int32 ``(query planes (Q, W), corpus planes (W, N))``."""
    queries = tuple(q.contiguous() for q in queries)
    planes_t = tuple(p.contiguous() for p in planes_t)
    if len(queries) != len(planes_t) or len(planes_t) not in (1, 2):
        raise ContractError(
            f"innr_tpu_torch::{op}: one plane each (binary) or two (ternary)")
    for t in (*queries, *planes_t):
        if t.dtype != torch.int32 or t.dim() != 2 or t.device != planes_t[0].device:
            raise ContractError(
                f"innr_tpu_torch::{op}: planes must be 2-D int32 on one device, got "
                f"{t.dtype} of shape {tuple(t.shape)} on {t.device}"
            )
    w, n = planes_t[0].shape
    if any(p.shape != planes_t[0].shape for p in planes_t) or any(
        q.shape != queries[0].shape or q.shape[1] != w for q in queries
    ):
        raise ContractError(
            f"innr_tpu_torch::{op}: query planes {[tuple(q.shape) for q in queries]} "
            f"don't match corpus planes {[tuple(p.shape) for p in planes_t]}"
        )
    if n > _knn._MAX_ROWS:
        raise ContractError(f"innr_tpu_torch::{op}: {n} rows; row indices are int32")
    if not 1 <= k <= n:
        raise ContractError(f"innr_tpu_torch::{op}: k={k} outside [1, {n}]")
    return queries, planes_t


def _plain_top(queries, planes_t, k: int, bound=None) -> torch.Tensor:
    """(Q, k) int64 composites, best first: chunks of corpus rows, each
    merged into a running top-k."""
    n_q, w = queries[0].shape
    n = planes_t[0].shape[1]
    step = max(row_scan.ROW_TILE, _PLAIN_CHUNK // max(1, n_q * w * len(planes_t)))
    qs = [q[:, :, None] for q in queries]

    def keys_of(s, e):
        keys = word_scores(qs, [p[None, :, s:e] for p in planes_t]).sum(dim=1, dtype=torch.int32)
        return -keys if len(planes_t) == 1 else keys

    return _knn._chunked_top(keys_of, n, step, k, bound, planes_t[0].device)


def packed_knn_plain(queries, planes_t, k: int, excl=None):
    """The plain version of the kernel. ``queries``: one (binary) or two
    (ternary: pos, neg) (Q, W) int32 planes; ``planes_t``: the matching
    (W, N) corpus planes. Returns raw ``(keys, idx)`` int32 (Q, k), best
    first: keys are ``-count`` (binary) or the dot (ternary).

    ``excl``: optional per-query ``(keys, idx)`` bound; only candidates
    strictly after it in (key desc, idx asc) order are kept."""
    queries, planes_t = _check(queries, planes_t, k, "packed_knn_plain")
    bound = None if excl is None else composite_keys(excl[0], excl[1])
    return split_composite(_plain_top(queries, planes_t, k, bound))


def _scan_pass(queries, planes_t, k: int, bound) -> torch.Tensor:
    """One kernel pass (packed_scan + knn_merge): (Q, k) int64 composites."""
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n_q, w = queries[0].shape
    n = planes_t[0].shape[1]
    binary = len(planes_t) == 1
    tile = row_scan.row_scan_tile(n_q, k, 4 * len(planes_t) * w, "packed_scan")
    out = _knn._scan_and_merge(
        "packed_scan",
        lambda partial, slab_rows, stream: lib.innr_packed_scan(
            0 if binary else 1, queries[0].data_ptr(),
            None if binary else queries[1].data_ptr(), planes_t[0].data_ptr(),
            None if binary else planes_t[1].data_ptr(), _knn._ptr(bound),
            partial, n_q, n, w, k, tile, slab_rows, stream),
        n_q, n, k, tile, row_scan.ROW_TILE, planes_t[0].device)
    LAUNCHES += 1
    LAUNCHES_BY_KIND["binary" if binary else "ternary"] += 1
    return out


def fused_packed_keys_batch(queries, planes_t, k: int):
    """Top-k raw int32 keys (``-count`` binary, dot ternary; larger is
    better) and int32 row indices, both (Q, k), for any k in [1, N]."""
    queries, planes_t = _check(queries, planes_t, k, "fused_packed_keys_batch")
    dev = planes_t[0].device
    if dev.type == "cpu" or config.reference_forced():
        run_pass = _plain_top
    elif dev.type == "cuda":
        run_pass = _scan_pass
    else:
        raise ContractError(f"innr_tpu_torch::packed_knn: unsupported device {dev}")
    comp = _knn._multi_pass(
        lambda pass_k, bound: run_pass(queries, planes_t, pass_k, bound),
        k, _knn.single_pass_k(queries[0].shape[0]),
    )
    return split_composite(comp)


def fused_binary_knn_batch(q_words, words_t, k: int):
    """Top-k smallest bit-Hamming for (Q, W) packed queries against a
    word-major (W, N) corpus: ``(counts (Q, k) int32 ascending, indices
    (Q, k) int32)``."""
    keys, idx = fused_packed_keys_batch((q_words,), (words_t,), k)
    return -keys, idx


def fused_binary_knn(q_words, words_t, k: int):
    """One (W,) query: ``(counts (k,) ascending, indices (k,))``."""
    counts, idx = fused_binary_knn_batch(q_words[None, :], words_t, k)
    return counts[0], idx[0]


def fused_ternary_knn_batch(qpos, qneg, pos_t, neg_t, k: int):
    """Top-k largest ternary dots for (Q, W) query planes against word-major
    (W, N) corpus planes: ``(dots (Q, k) int32 descending, indices (Q, k)
    int32)``."""
    return fused_packed_keys_batch((qpos, qneg), (pos_t, neg_t), k)


def fused_ternary_knn(qpos, qneg, pos_t, neg_t, k: int):
    """One query's (W,) planes: ``(dots (k,) descending, indices (k,))``."""
    dots, idx = fused_ternary_knn_batch(qpos[None, :], qneg[None, :], pos_t, neg_t, k)
    return dots[0], idx[0]
