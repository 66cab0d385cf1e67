"""Fused sparse-dot kNN: the CUDA kernel and its plain version.

Replaces the TPU kernel ``innr_tpu/kernels/sparse_knn.py:_sparse_kernel``
(launched by ``fused_sparse_knn``): the k largest sparse dots of sorted
``(index, value)`` queries against a sparse corpus. The kernel is
``csrc/sparse_knn.cu`` (``sparse_scan``, then ``knn_merge`` from
``csrc/knn.cu``): one hash lookup of each corpus entry in a shared-memory
table of the union of the query tile's ids, each with its queries' values
and a mask of the queries that hold it, where the TPU swept the query with
compare-selects. Its source note says what bounds it on the
H100.

Semantics are the JAX package's join (``innr_tpu/ops/sparse.py:
_join_scores``), :func:`join_scores` here: query indices sorted ascending
(as unsigned), a duplicate query index matches its first occurrence,
sentinel-padded corpus entries (index 0xFFFFFFFF, value 0.0) contribute
nothing, a NaN or inf value counts only when its entry matches, and a
document with no match scores +0.0. Indices are ``uint32`` held as
bit-identical ``int32`` views (:mod:`innr_tpu_torch.utils.bits`): the
plain version searches on ``idx & 0xFFFFFFFF`` as int64 and the kernel
compares as unsigned, so indices >= 2**31 (hashed index spaces, the
sentinel) order as the JAX package's ``uint32`` do.

The corpus is entry-major, ``(L, N)``, the JAX package's cached transposes
(``SparseCorpus._transposed``). Selection runs on K1's composites of the
score's total-order key (NaN canonicalised): the k largest, NaN first,
ties to the lowest document. Any k runs through K1's exclusion-bounded
multi-pass driver (:func:`.knn._multi_pass`).

Dispatch: a CUDA tensor runs the kernel, or the call raises; a CPU tensor,
or :func:`innr_tpu_torch.config.force_reference`, runs the plain version.
Any query length runs in the kernel: a query tile whose table does not fit
in shared memory (a single query of thousands of entries) gets its table
in global memory, where L2 holds it (:func:`_table_plan`), with the same
lookups and sums, bit for bit.
"""

from __future__ import annotations

import torch

from innr_tpu_torch import config
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.kernels import row_scan
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import (
    canonical_nan,
    composite_keys,
    invert_total_key,
    split_composite,
    total_order_key_f32,
)

# The JAX package's longest query for its fused kernel (longer ones go to
# its XLA join, which has the same contract). Kept for API parity: the
# kernel here takes any query that fits in shared memory.
MAX_QUERY_NNZ = 256

# Corpus entries per chunk of the plain version, which runs over documents
# in chunks with a running top-k.
_PLAIN_CHUNK = 1 << 24
_LOW32 = 0xFFFFFFFF
# csrc/sparse_knn.cu: a shared-memory hash slot holds a union index in 16
# bits. A table in global memory has no such limit; its query tile is the
# largest whose table stays within _GLOBAL_TABLE_BYTES (the H100's L2 is 50 MB), else 1.
_MAX_UNION = 1 << 16
_GLOBAL_TABLE_BYTES = 8 << 20

# Kernel passes launched (each pass launches sparse_scan, then knn_merge).
# Incremented only where the kernels launch.
LAUNCHES = 0


def join_scores(q_idx, q_val, idx, val, dim: int = -1) -> torch.Tensor:
    """One sorted (Lq,) query joined into index / value tensors of any
    shape, the dot taken over ``dim``: the JAX package's ``_join_scores``.
    Indices are int32 views of uint32, searched as unsigned."""
    lq = q_idx.shape[-1]
    if lq == 0 or idx.shape[dim] == 0:
        return torch.zeros_like(val, dtype=torch.float32).sum(dim=dim)
    qk = q_idx.to(torch.int64) & _LOW32
    ck = (idx.to(torch.int64) & _LOW32).contiguous()
    pos = torch.searchsorted(qk, ck).clamp_(max=lq - 1)
    matched = qk[pos] == ck
    # "+ 0.0" turns a -0.0 sum into +0.0: the JAX reduction and the kernel
    # both start from +0.0.
    return torch.where(matched, val * q_val[pos], 0.0).sum(dim=dim) + 0.0


def _check(q_idx, q_val, idx_t, val_t, k: int, op: str) -> None:
    if (idx_t.dim() != 2 or idx_t.dtype != torch.int32 or val_t.dtype != torch.float32
            or val_t.shape != idx_t.shape):
        raise ContractError(
            f"innr_tpu_torch::{op}: the corpus must be (L, N) int32 indices and float32 values, "
            f"got {idx_t.dtype} {tuple(idx_t.shape)} / {val_t.dtype} {tuple(val_t.shape)}")
    if (q_idx.dim() != 2 or q_idx.dtype != torch.int32 or q_val.dtype != torch.float32
            or q_val.shape != q_idx.shape):
        raise ContractError(
            f"innr_tpu_torch::{op}: queries must be (Q, Lq) int32 indices and float32 values, "
            f"got {q_idx.dtype} {tuple(q_idx.shape)} / {q_val.dtype} {tuple(q_val.shape)}")
    devs = {t.device for t in (q_idx, q_val, idx_t, val_t)}
    if len(devs) != 1:
        raise ContractError(f"innr_tpu_torch::{op}: tensors on several devices {devs}")
    n = idx_t.shape[1]
    if n > _knn._MAX_ROWS:
        raise ContractError(f"innr_tpu_torch::{op}: {n} documents; indices are int32")
    if not 1 <= k <= n:
        raise ContractError(f"innr_tpu_torch::{op}: k={k} outside [1, {n}]")


def _plain_top(q_idx, q_val, idx_t, val_t, k: int, bound=None) -> torch.Tensor:
    """(Q, k) int64 composites of the scores' total-order keys, best first."""
    l, n = idx_t.shape
    step = max(row_scan.ROW_TILE, _PLAIN_CHUNK // max(1, l))

    def keys_of(a, b):
        scores = torch.stack([join_scores(qi, qv, idx_t[:, a:b], val_t[:, a:b], dim=0)
                              for qi, qv in zip(q_idx, q_val)])
        return total_order_key_f32(canonical_nan(scores))

    return _knn._chunked_top(keys_of, n, step, k, bound, idx_t.device)


def sparse_knn_plain(q_idx, q_val, idx_t, val_t, k: int, excl=None):
    """The plain version of the kernel. ``q_idx`` / ``q_val``: (Q, Lq)
    int32 / float32, each row sorted ascending as unsigned; ``idx_t`` /
    ``val_t``: the (L, N) corpus. Returns raw ``(keys, idx)`` int32 (Q, k),
    best first, keys the scores' total-order keys.

    ``excl``: optional per-query ``(keys, idx)`` bound; only candidates
    strictly after it in (key desc, idx asc) order are kept."""
    _check(q_idx, q_val, idx_t, val_t, k, "sparse_knn_plain")
    bound = None if excl is None else composite_keys(excl[0], excl[1])
    return split_composite(_plain_top(q_idx, q_val, idx_t, val_t, k, bound))


def _table_smem(tile: int, lq: int, k: int, spread: int = 2) -> tuple[int, int]:
    """``(bytes, hash bits)`` of a query tile's table in ``csrc/
    sparse_knn.cu``: beside the top-k part (``row_scan.cuh``), each of the
    at most ``tile Lq`` union ids holds ``tile`` values (``tile + 1``
    floats apart for several queries) and a mask, and the hash at least
    ``2^spread`` times as many 8-byte slots (16 at least)."""
    u_max = max(1, tile * lq)
    hbits = max(4, ((1 << spread) * u_max - 1).bit_length())
    topk = 8 * (max(tile, 8) * k + row_scan.MAX_QUERY_TILE) + 4 * tile * row_scan.ROW_TILE
    stride = tile + 1 if tile > 1 else 1
    return topk + 8 * (1 << hbits) + 4 * u_max * (stride + 1) + 16, hbits


def _global_table(n_q: int, lq: int, k: int) -> tuple[int, int, int]:
    """``(query tile, hash bits, bytes of one tile's table)`` of a table in
    global memory, the hash at most a quarter full: the largest power of
    two <= :func:`.row_scan.query_tile` whose table stays within
    ``_GLOBAL_TABLE_BYTES`` and whose top-k buffers fit in shared memory,
    else 1. Raises :class:`ContractError` when even one query's top-k
    buffers do not fit (k beyond any pass cap)."""
    def table(tile):
        u_max = max(1, tile * lq)
        hbits = max(4, (4 * u_max - 1).bit_length())
        stride = tile + 1 if tile > 1 else 1
        return hbits, -(-(8 * (1 << hbits) + 4 * u_max * (stride + 1) + 4) // 16) * 16

    tile = row_scan.row_scan_tile(n_q, k, 0, "sparse_scan")
    while tile > 1 and table(tile)[1] > _GLOBAL_TABLE_BYTES:
        tile //= 2
    return (tile, *table(tile))


def _table_tile(n_q: int, lq: int, k: int) -> tuple[int, int]:
    """``(query tile, hash bits)`` of a table in shared memory: the largest
    power of two <= :func:`.row_scan.query_tile` whose table fits with the
    hash at most half full; then a quarter full where that fits too and
    keeps two CTAs per SM if half full did. Raises :class:`ContractError`
    naming the limit when a single query's table does not fit (then
    :func:`_table_plan` puts the tables in global memory)."""
    tile = row_scan.query_tile(n_q)
    while tile > 1 and _table_smem(tile, lq, k, 1)[0] > row_scan.SMEM_LIMIT:
        tile //= 2
    need, hbits = _table_smem(tile, lq, k, 1)
    if need > row_scan.SMEM_LIMIT or tile * lq > _MAX_UNION:
        raise ContractError(
            f"innr_tpu_torch::sparse_scan: a query of {lq} entries needs "
            f"{_table_smem(1, lq, k, 1)[0]} bytes of shared memory at k={k}; a CTA has at most "
            f"{row_scan.SMEM_LIMIT}")
    wide, wbits = _table_smem(tile, lq, k, 2)
    two_per_sm = row_scan.SMEM_LIMIT // 2 - 1024
    if wide <= row_scan.SMEM_LIMIT and (wide <= two_per_sm or need > two_per_sm):
        hbits = wbits
    return tile, hbits


def _table_plan(n_q: int, lq: int, k: int) -> tuple[int, int, int]:
    """``(query tile, hash bits, bytes of one tile's table in global
    memory)``: :func:`_table_tile` with 0 bytes when one query's table fits
    in shared memory, else :func:`_global_table`."""
    if _table_smem(1, lq, k, 1)[0] > row_scan.SMEM_LIMIT or lq > _MAX_UNION:
        return _global_table(n_q, lq, k)
    return (*_table_tile(n_q, lq, k), 0)


def _scan_pass(q_idx, q_val, idx_t, val_t, k: int, bound) -> torch.Tensor:
    """One kernel pass (sparse_scan + knn_merge): (Q, k) int64 composites."""
    global LAUNCHES
    from innr_tpu_torch.kernels import _build

    lib = _build.load()
    n_q, lq = q_idx.shape
    l, n = idx_t.shape
    tile, hbits, in_global = _table_plan(n_q, lq, k)
    table = None
    if in_global:  # one table per query tile, laid out as the library sizes it
        per_tile = lib.innr_sparse_table_bytes(tile, lq, hbits)
        table = torch.empty(per_tile * -(-n_q // tile), dtype=torch.uint8, device=idx_t.device)
    out = _knn._scan_and_merge(
        "sparse_scan",
        lambda partial, slab_rows, stream: lib.innr_sparse_scan(
            q_idx.data_ptr(), q_val.data_ptr(), idx_t.data_ptr(), val_t.data_ptr(),
            _knn._ptr(bound), _knn._ptr(table), 0 if table is None else table.numel(), partial,
            n_q, n, l, lq, hbits, k, tile, slab_rows, stream),
        n_q, n, k, _knn._slab_rows(n, -(-n_q // tile), k, idx_t.device, row_scan.ROW_TILE),
        idx_t.device)
    LAUNCHES += 1
    return out


def fused_sparse_keys_batch(q_idx, q_val, idx_t, val_t, k: int):
    """Top-k raw int32 total-order keys of the scores and int32 document
    indices, both (Q, k), for any k in [1, N]."""
    _check(q_idx, q_val, idx_t, val_t, k, "fused_sparse_keys_batch")
    dev = idx_t.device
    if dev.type == "cpu" or config.reference_forced():
        run_pass = _plain_top
    elif dev.type == "cuda":
        q_idx, q_val = q_idx.contiguous(), q_val.contiguous()
        idx_t, val_t = idx_t.contiguous(), val_t.contiguous()
        run_pass = _scan_pass
    else:
        raise ContractError(f"innr_tpu_torch::sparse_knn: unsupported device {dev}")
    comp = _knn._multi_pass(
        lambda pass_k, bound: run_pass(q_idx, q_val, idx_t, val_t, pass_k, bound),
        k, _knn.single_pass_k(q_idx.shape[0]),
    )
    return split_composite(comp)


def fused_sparse_knn_batch(q_idx, q_val, idx_t, val_t, k: int):
    """Top-k largest sparse dots of (Q, Lq) padded queries against an
    entry-major corpus: ``(scores (Q, k) float32 descending under IEEE total
    order, indices (Q, k) int32)``."""
    keys, idx = fused_sparse_keys_batch(q_idx, q_val, idx_t, val_t, k)
    return invert_total_key(keys), idx


def fused_sparse_knn(q_idx, q_val, idx_t, val_t, k: int, fast: bool = False):
    """One sorted (Lq,) query: ``(scores (k,), indices (k,))``.

    ``fast`` is the JAX package's all-finite sweep flag, kept for API
    parity: the binary search needs no match tracker, so one path is exact
    for every corpus and the flag selects nothing."""
    del fast
    scores, idx = fused_sparse_knn_batch(q_idx[None, :], q_val[None, :], idx_t, val_t, k)
    return scores[0], idx[0]
