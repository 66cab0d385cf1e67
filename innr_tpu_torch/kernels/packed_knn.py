"""Fused packed-corpus kNN: the CUDA kernel and its plain version.

Replaces the TPU kernels of ``innr_tpu/kernels/packed_knn.py``:
``_binary_kernel`` / ``_binary_kernel_mq`` (the k smallest XOR-popcount
counts) and ``_ternary_kernel`` / ``_ternary_kernel_mq`` (the k largest
ternary dots), for one query or a batch. The kernel is
``csrc/packed_knn.cu``: ``packed_scan`` computes every (row, query) count
on the b1 tensor cores (``mma.sync ... b1.and.popc``: Hamming as
``popc(x) + popc(q) - 2 popc(x & q)``, the ternary dot as two sums over
both planes), exact in int32, and offers a pair to the CTA's top-k only
if its key reaches the query's threshold; ``packed_merge`` then selects
from the slabs' partial lists only the keys that reach the best k-th key
any CTA published. Its source note says what bounds it on the H100: the
corpus read. :func:`tiling` picks the query tile (8, 16, 32 or 64 queries
per CTA) and the shared-memory layout.

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

import ctypes
from contextlib import nullcontext
from typing import NamedTuple

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

# The scan's geometry (csrc/packed_knn.cu): rows per CTA tile (slabs are
# whole tiles), k-steps of 256 bits per item, warps per CTA, and the query
# tiles it is built for.
ROW_TILE = 128
CHUNK_STEPS = 3
_WARPS = 4
QUERY_TILES = (8, 16, 32, 64)
TILE_PAIRS = 4096
MAX_WORDS = 1 << 24
_PLANS: dict = {}

# Kernel passes launched (each pass launches packed_scan, then packed_merge),
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


class Tiling(NamedTuple):
    """The scan's shape for one pass: queries per CTA, k-steps of 256 bits
    per plane (``ceil(W / 8)``), shared-memory bytes per CTA, and whether
    every k-step of the queries is resident (else staged per item)."""

    query_tile: int
    steps: int
    smem: int
    resident: bool


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(planes: int, query_tile: int, w: int, k: int, resident: bool) -> int:
    """Shared-memory bytes of one CTA (``make_layout`` in
    ``csrc/packed_knn.cu``): the (tile, k) int64 buffers, each query's pool
    of a row tile's admitted composites, each warp's merge output, the
    exclusion bounds, the queries' B fragments (all k-steps, or one item's),
    the gate, popc(q), the pool counts and counters."""
    steps = -(-w // 8)
    at = _align16(8 * query_tile * k)
    at = _align16(at + 8 * query_tile * 2 * ROW_TILE)
    at = _align16(at + 8 * _WARPS * k)
    at = _align16(at + 8 * query_tile)
    at = _align16(at + 32 * planes * (steps if resident else CHUNK_STEPS) * query_tile)
    at = _align16(at + 8 * query_tile)
    at = _align16(at + 4 * query_tile)
    at = _align16(at + 4 * query_tile)
    return at + 16


def tiling(n_q: int, w: int, k: int, planes: int, op: str = "packed_scan") -> Tiling:
    """The smallest query tile of :data:`QUERY_TILES` that holds
    ``min(n_q, 64)``, halved while it holds more than :data:`TILE_PAIRS`
    top-k slots (tile x k: each warp merges the admitted pairs of a quarter
    of the tile's queries in turn, so at large k narrower tiles, more CTAs
    and more corpus reads finish sooner) and while it does not fit in
    shared memory; the queries resident when they fit, else staged per
    item. Raises :class:`ContractError` naming the limit when even 8
    queries do not fit, or when W reaches :data:`MAX_WORDS` (the int32
    keys and their gate need 32 W < 2^30)."""
    if w >= MAX_WORDS:
        raise ContractError(f"innr_tpu_torch::{op}: {w} words a row; the scan takes fewer than "
                            f"{MAX_WORDS}")
    tile = QUERY_TILES[0]
    while tile < QUERY_TILES[-1] and tile < n_q:
        tile *= 2
    while tile > QUERY_TILES[0] and tile * k > TILE_PAIRS:
        tile //= 2
    steps = -(-w // 8)
    while True:
        for resident in (True, False):
            smem = smem_bytes(planes, tile, w, k, resident)
            if smem <= row_scan.SMEM_LIMIT:
                return Tiling(tile, steps, smem, resident)
        if tile == QUERY_TILES[0]:
            raise ContractError(
                f"innr_tpu_torch::{op}: k={k} needs {smem} bytes of shared memory for a tile "
                f"of {tile} queries; a CTA has at most {row_scan.SMEM_LIMIT}")
        tile //= 2


def _plan(lib, binary: bool, n_q: int, w: int, n: int, k: int, dev) -> tuple:
    """``(tiling, slab_rows, n_slabs)`` of one pass: one wave of the CTAs
    resident per SM at this shape, as the library plans its launch (its
    shared-memory bytes checked against :func:`smem_bytes`). Cached per
    shape."""
    key = (binary, n_q, w, n, k, dev)
    if key not in _PLANS:
        tl = tiling(n_q, w, k, 1 if binary else 2)
        info = (ctypes.c_int * 2)()
        with torch.cuda.device(dev):
            rc = lib.innr_packed_grid(0 if binary else 1, tl.query_tile, w, k,
                                      int(tl.resident), info)
        if rc != 0 or info[0] != tl.smem:
            raise RuntimeError(f"innr_tpu_torch: packed_grid failed (cudaError {rc}); shared "
                               f"bytes {info[0]}, expected {tl.smem}")
        slab_rows = _knn._slab_rows(n, -(-n_q // tl.query_tile), k, dev, ROW_TILE,
                                    max(1, info[1]), 1)
        _PLANS[key] = (tl, slab_rows, -(-n // slab_rows))
    return _PLANS[key]


def _scan_pass(queries, planes_t, k: int, bound, split: bool = False):
    """One kernel pass (packed_scan, then packed_merge, in one library
    call): (Q, k) int64 composites, or with ``split`` the ``(keys, idx)``
    int32 pair."""
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n_q, w = queries[0].shape
    n = planes_t[0].shape[1]
    binary = len(planes_t) == 1
    dev = planes_t[0].device
    tl, slab_rows, n_slabs = _plan(lib, binary, n_q, w, n, k, dev)
    # One scratch allocation: the slabs' partial lists, the k-th keys, the
    # composites (without split). Launches go to the current device.
    n_part, n_kth = n_slabs * n_q * k, -(-n_q // 2)
    with torch.cuda.device(dev) if dev.index != torch.cuda.current_device() else nullcontext():
        scratch = torch.empty(n_part + n_kth + (0 if split else n_q * k), dtype=torch.int64,
                              device=dev)
        base = scratch.data_ptr()
        if split:
            res = torch.empty((2, n_q, k), dtype=torch.int32, device=dev)
            outs = (None, res.data_ptr(), res.data_ptr() + 4 * n_q * k)
        else:
            res = scratch[n_part + n_kth:].view(n_q, k)
            outs = (res.data_ptr(), None, None)
        rc = lib.innr_packed_scan(
            0 if binary else 1, queries[0].data_ptr(), None if binary else queries[1].data_ptr(),
            planes_t[0].data_ptr(), None if binary else planes_t[1].data_ptr(), _knn._ptr(bound),
            base + 8 * n_part, base, *outs, n_q, n, w, k, tl.query_tile, int(tl.resident),
            slab_rows, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"innr_tpu_torch: packed_scan launch failed, cudaError {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_KIND["binary" if binary else "ternary"] += 1
    return (res[0], res[1]) if split else res


def fused_packed_keys_batch(queries, planes_t, k: int):
    """Top-k raw int32 keys (``-count`` binary, dot ternary; larger is
    better) and int32 row indices, both (Q, k), for any k in [1, N]."""
    queries, planes_t = _check(queries, planes_t, k, "fused_packed_keys_batch")
    dev = planes_t[0].device
    cap = _knn.single_pass_k(queries[0].shape[0])
    if dev.type == "cpu" or config.reference_forced():
        run_pass = _plain_top
    elif dev.type == "cuda":
        if k <= cap:  # one pass: the merge writes keys and rows itself
            return _scan_pass(queries, planes_t, k, None, split=True)
        run_pass = _scan_pass
    else:
        raise ContractError(f"innr_tpu_torch::packed_knn: unsupported device {dev}")
    comp = _knn._multi_pass(lambda pass_k, bound: run_pass(queries, planes_t, pass_k, bound),
                            k, cap)
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
