"""Batch vector ops and the kNN family.

The counterpart of :mod:`innr_tpu.batch`. :class:`VerticalBatch` keeps the
reference's dimension-major API (constructors, accessors, the ``data()``
serialization order) over a row-major ``(N, D)`` tensor, the layout the
kNN kernel streams.

- ``batch_knn`` / ``batch_knn_filtered``: L2^2, ascending.
- ``batch_knn_dot`` / ``batch_knn_cosine``: similarity, descending.
- Orderings follow IEEE total order with lowest-index ties.

Every kNN function takes one query (D,) or a batch (Q, D) and any k, and
runs the fused kNN kernel (:mod:`innr_tpu_torch.kernels.knn`) for a corpus
on a CUDA device, or its plain version for a corpus on the CPU.

Tile-skip pruning (:mod:`innr_tpu_torch.prune`): ``prune=True`` on
``batch_knn`` / ``batch_knn_dot`` / ``batch_knn_cosine`` plans survivor
tiles from the batch's cached :meth:`VerticalBatch.tile_summary` and runs
the tile scan (:mod:`innr_tpu_torch.kernels.pruned_knn`): the same exact
results, reading only tiles that can hold a winner.
``batch_l2_squared_pruning`` runs the tile-skipping threshold scan, and
``batch_knn_adaptive`` is the exact pruned scan unless asked for the
approximate warmup path. This package has no ``MIN_ROWS_PALLAS`` size
gate: a corpus of any size takes these paths.

While a profiler records (:mod:`innr_tpu_torch.utils.trace`), a
``batch_knn`` / ``batch_knn_dot`` / ``batch_knn_cosine`` call is an
``index.call`` span whose first child, ``index.to_device``, is the copy of
its queries to the device and whose last, ``index.to_host``, the copy of
its result to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from innr_tpu_torch import config
from innr_tpu_torch.config import NORM_EPSILON
from innr_tpu_torch.kernels import knn as _kernels
from innr_tpu_torch.kernels import pruned_knn as _pruned
from innr_tpu_torch.prune import build_tile_summary, cluster_reorder, suggest_tile_n
from innr_tpu_torch.utils import trace as _trace
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import composite_keys, top_k_total, total_order_key_f32
from innr_tpu_torch.utils.padding import round_up
from innr_tpu_torch.utils.tensors import host_device, to_host

__all__ = [
    "VerticalBatch",
    "BatchKnnResult",
    "batch_l2_squared",
    "batch_l2_squared_into",
    "batch_dot",
    "batch_dot_into",
    "batch_norms",
    "batch_norms_into",
    "batch_cosine",
    "batch_cosine_into",
    "batch_dimension_variance",
    "batch_knn",
    "batch_knn_dot",
    "batch_knn_cosine",
    "batch_knn_filtered",
    "batch_knn_reordered",
    "batch_knn_adaptive",
    "batch_l2_squared_pruning",
]

_DTYPES = (torch.float32, torch.bfloat16)


def _bf16_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A bfloat16 numpy array (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects) as a torch tensor with the same bits."""
    bits = np.ascontiguousarray(arr).view(np.uint16)
    if not bits.flags.writeable:
        bits = bits.copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


class VerticalBatch:
    """Corpus container for batch scans (reference ``src/batch.rs:88``).

    ``rows``: an (N, D) float32 or bfloat16 tensor. ``dtype=torch.bfloat16``
    stores the corpus in half precision: scans read half the bytes, and
    scores carry bf16 input rounding (~1e-2 relative). Host data goes to
    ``device``, default :func:`innr_tpu_torch.config.default_device` (the
    card); a tensor stays on its device unless ``device`` is given.
    """

    __slots__ = ("rows", "_norms2", "_inv_norms", "_tile_summary", "_tile_summary_norm",
                 "_prune_tile_n")

    def __init__(self, rows, dtype=torch.float32, device=None):
        if dtype not in _DTYPES:
            raise ContractError("VerticalBatch: dtype must be float32 or bfloat16")
        if isinstance(rows, torch.Tensor):
            rows = rows.to(device=device if device is not None else rows.device, dtype=dtype)
        else:
            arr = np.asarray(rows)
            if arr.dtype.name == "bfloat16":
                rows = _bf16_from_numpy(arr).to(device=host_device(device), dtype=dtype)
            else:
                rows = torch.as_tensor(
                    np.asarray(arr, dtype=np.float32), device=host_device(device)
                ).to(dtype)
        if rows.dim() != 2:
            raise ContractError(
                f"VerticalBatch: rows must be 2-D (N, D), got {tuple(rows.shape)}"
            )
        self.rows = rows.contiguous()
        # Per-row norm caches: computing them inside each L2 / cosine scan
        # would cost a second corpus read per call.
        self._norms2 = None
        self._inv_norms = None
        self._tile_summary = None
        self._tile_summary_norm = None
        self._prune_tile_n = None

    def norms2(self) -> torch.Tensor:
        """Per-row squared L2 norms (float32), computed once and cached."""
        if self._norms2 is None:
            self._norms2 = _kernels._norms2(self.rows)
        return self._norms2

    def inv_norms(self) -> torch.Tensor:
        """Per-row guarded inverse norms (zero-norm -> 0.0), cached."""
        if self._inv_norms is None:
            self._inv_norms = _kernels.inv_norms(self.rows)
        return self._inv_norms

    def set_prune_tile_n(self, tile_n) -> "VerticalBatch":
        """Override the pruning tile height (a layout knob): rounded up to
        a multiple of 128 and capped at ``pruned_tile_n``; ``None`` restores
        the default. Clusters smaller than a tile cannot prune, so pass
        about the cluster size for fine-grained corpora. Results never
        depend on it. Clears the cached summaries; returns self."""
        if tile_n is not None:
            tile_n = int(tile_n)
            if tile_n <= 0:
                raise ContractError("set_prune_tile_n: tile_n must be positive or None")
            cap = _pruned.pruned_tile_n(self.num_vectors, self.dimension, self.rows.dtype)
            tile_n = min(round_up(tile_n, 128), cap)
        self._prune_tile_n = tile_n
        self._tile_summary = None
        self._tile_summary_norm = None
        return self

    def _tile_n(self) -> int:
        if self._prune_tile_n is not None:
            return self._prune_tile_n
        return _pruned.pruned_tile_n(self.num_vectors, self.dimension, self.rows.dtype)

    def tile_summary(self, normalized: bool = False):
        """Per-tile (centroid, radius) bounds for tile-skip pruning
        (:mod:`innr_tpu_torch.prune`), built in one corpus pass and cached.
        ``normalized=True``: the unit-row summary the cosine scan plans
        against (cached apart). Tile height: :meth:`set_prune_tile_n`, else
        ``pruned_tile_n``."""
        if normalized:
            if self._tile_summary_norm is None:
                self._tile_summary_norm = build_tile_summary(
                    self.rows, self._tile_n(), normalized=True)
            return self._tile_summary_norm
        if self._tile_summary is None:
            self._tile_summary = build_tile_summary(self.rows, self._tile_n())
        return self._tile_summary

    def cluster_reorder(self, n_clusters: int = 256, n_iters: int = 5, seed: int = 0,
                        sample: int = 65536):
        """Layout pass for ``prune=True``: ``(reordered VerticalBatch,
        perm)``, ``perm`` the (N,) int32 permutation on the batch's device
        (``new.rows[i] == self.rows[perm[i]]``; map a kNN index ``j`` on the
        new batch back as ``perm[j]``). Everything runs on the device
        (:func:`innr_tpu_torch.prune.cluster_reorder`), and the new batch's
        tile height comes from the cluster sizes
        (:func:`~innr_tpu_torch.prune.suggest_tile_n`). Results of pruned
        scans never depend on the layout, only how much they prune."""
        reordered, perm, sizes = cluster_reorder(
            self.rows, n_clusters=n_clusters, n_iters=n_iters, seed=seed, sample=sample)
        out = VerticalBatch(reordered, dtype=self.rows.dtype)
        out.set_prune_tile_n(
            suggest_tile_n(sizes, self.num_vectors, self.dimension, self.rows.dtype))
        return out, perm

    # -- constructors (reference src/batch.rs:103/138/167) ------------------

    @classmethod
    def from_numpy(cls, rows: np.ndarray, dtype=torch.float32, device=None) -> "VerticalBatch":
        """From an (N, D) numpy array, e.g. ``np.asarray`` of an
        ``innr_tpu`` batch's rows. A bfloat16 array keeps its bits exactly."""
        return cls(rows, dtype=dtype, device=device)

    @classmethod
    def from_rows(cls, vectors, device=None) -> "VerticalBatch":
        """Build from a sequence of equal-length vectors (row-major)."""
        if isinstance(vectors, (np.ndarray, torch.Tensor)):
            return cls(vectors, device=device)
        vectors = list(vectors)
        if not vectors:
            return cls(np.zeros((0, 0), dtype=np.float32), device=device)
        dim = len(vectors[0])
        for v in vectors:
            if len(v) != dim:
                raise ContractError("VerticalBatch: inconsistent vector dimension")
        return cls(np.asarray(vectors, dtype=np.float32), device=device)

    @classmethod
    def from_slices(cls, vectors, device=None) -> "VerticalBatch":
        """Alias of :meth:`from_rows` (reference ``src/batch.rs:138``)."""
        return cls.from_rows(vectors, device=device)

    @classmethod
    def from_flat(cls, data, num_vectors: int, dimension: int, device=None) -> "VerticalBatch":
        """Build from flat row-major data (reference ``src/batch.rs:167``)."""
        flat = np.asarray(data, dtype=np.float32).reshape(-1)
        if flat.size != num_vectors * dimension:
            raise ContractError(
                f"VerticalBatch.from_flat: {flat.size} values != "
                f"{num_vectors} x {dimension}"
            )
        return cls(flat.reshape(num_vectors, dimension), device=device)

    # -- accessors -----------------------------------------------------------

    @property
    def num_vectors(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    def get(self, dim: int, vec_idx: int) -> float:
        """Value at (dimension, vector_index) — reference argument order."""
        return float(self.rows[vec_idx, dim])

    def dimension_slice(self, dim: int) -> torch.Tensor:
        """One dimension across all vectors (reference ``src/batch.rs:193``)."""
        return self.rows[:, dim]

    def data(self) -> np.ndarray:
        """Flat float32 data in the reference's dimension-major order
        (``data[d * num_vectors + i]``, reference ``src/batch.rs:212``)."""
        return self.rows.float().cpu().numpy().T.reshape(-1)

    def extract_vector(self, vec_idx: int) -> torch.Tensor:
        return self.rows[vec_idx]

    def __repr__(self) -> str:  # pragma: no cover
        return f"VerticalBatch(num_vectors={self.num_vectors}, dimension={self.dimension})"


@dataclass
class BatchKnnResult:
    """kNN result (reference ``src/batch.rs:369``): host numpy arrays.
    L2^2 for ``batch_knn`` / ``batch_knn_filtered`` (lower = closer),
    similarity for ``batch_knn_dot`` / ``batch_knn_cosine``."""

    indices: np.ndarray
    scores: np.ndarray


# ---------------------------------------------------------------------------
# batch scores (plain matrix products, as the JAX package leaves them to XLA)
# ---------------------------------------------------------------------------

def _check_query(query, batch: VerticalBatch, op: str, allow_multi: bool = False) -> torch.Tensor:
    q = torch.as_tensor(query, dtype=torch.float32, device=batch.rows.device)
    ok_rank = q.dim() == 1 or (allow_multi and q.dim() == 2)
    if not ok_rank or q.shape[-1] != batch.dimension:
        raise ContractError(
            f"innr_tpu_torch::{op}: query shape {tuple(q.shape)} incompatible "
            f"with batch dimension {batch.dimension}"
        )
    return q.contiguous()


def batch_l2_squared(query, batch: VerticalBatch) -> torch.Tensor:
    """Squared L2 from query to every vector (reference ``src/batch.rs:236``)."""
    q = _check_query(query, batch, "batch_l2_squared")
    diff = batch.rows.float() - q[None, :]
    return (diff * diff).sum(dim=1)


def batch_l2_squared_into(query, batch: VerticalBatch) -> torch.Tensor:
    """Alias of :func:`batch_l2_squared`."""
    return batch_l2_squared(query, batch)


def batch_dot(query, batch: VerticalBatch) -> torch.Tensor:
    """Dot products with every vector (reference ``src/batch.rs:270``)."""
    q = _check_query(query, batch, "batch_dot")
    return batch.rows.float() @ q


def batch_dot_into(query, batch: VerticalBatch) -> torch.Tensor:
    """Alias of :func:`batch_dot` (reference ``src/batch.rs:284``)."""
    return batch_dot(query, batch)


def batch_norms(batch: VerticalBatch) -> torch.Tensor:
    """Per-vector L2 norms (reference ``src/batch.rs:652``)."""
    return torch.sqrt(_kernels._norms2(batch.rows))


def batch_norms_into(batch: VerticalBatch) -> torch.Tensor:
    """Alias of :func:`batch_norms`."""
    return batch_norms(batch)


def batch_cosine(query, batch: VerticalBatch, norms=None) -> torch.Tensor:
    """Cosine similarities with precomputed norms (reference
    ``src/batch.rs:679``). Zero query norm -> all zeros; zero vector norm ->
    0.0 for that vector."""
    q = _check_query(query, batch, "batch_cosine")
    if norms is None:
        norms = batch_norms(batch)
    norms = torch.as_tensor(norms, dtype=torch.float32, device=batch.rows.device)
    if norms.shape[0] != batch.num_vectors:
        raise ContractError(
            f"innr_tpu_torch::batch_cosine: norms length {norms.shape[0]} != "
            f"num_vectors {batch.num_vectors}"
        )
    dots = batch.rows.float() @ q
    qn = torch.sqrt((q * q).sum())
    ok = (qn > NORM_EPSILON) & (norms > NORM_EPSILON)
    return torch.where(ok, dots / torch.where(ok, qn * norms, 1.0), 0.0)


def batch_cosine_into(query, batch: VerticalBatch, norms=None) -> torch.Tensor:
    """Alias of :func:`batch_cosine`."""
    return batch_cosine(query, batch, norms)


def batch_dimension_variance(batch: VerticalBatch) -> torch.Tensor:
    """Per-dimension population variance (reference ``src/batch.rs:561``)."""
    if batch.num_vectors <= 1 or batch.dimension == 0:
        return torch.zeros(batch.dimension, dtype=torch.float32, device=batch.rows.device)
    rows = batch.rows.float()
    mean = rows.mean(dim=0)
    return ((rows - mean[None, :]) ** 2).mean(dim=0)


# ---------------------------------------------------------------------------
# kNN family
# ---------------------------------------------------------------------------

def _empty_result(q) -> BatchKnnResult:
    """Empty result; shaped (Q, 0) for a query batch."""
    shape = (0,) if q.dim() == 1 else (int(q.shape[0]), 0)
    return BatchKnnResult(
        indices=np.zeros(shape, dtype=np.int64),
        scores=np.zeros(shape, dtype=np.float32),
    )


def _result(q, vals, idx) -> BatchKnnResult:
    if q.dim() == 1:
        vals, idx = vals[0], idx[0]
    with _trace.span("index.to_host"):
        scores, indices = to_host(vals, idx)
        return BatchKnnResult(indices=indices, scores=scores)


def _queries(q) -> torch.Tensor:
    return q if q.dim() == 2 else q[None, :]


def batch_knn(query, batch: VerticalBatch, k: int, prune: bool = False) -> BatchKnnResult:
    """Exact k nearest neighbors by squared L2 (reference ``src/batch.rs:385``).
    Scores ascending; k is capped at N. ``prune=True``: the tile-skipping
    scan, the same results reading only tiles that can hold a winner."""
    with _trace.span("index.call"):
        with _trace.span("index.to_device"):
            q = _check_query(query, batch, "batch_knn", allow_multi=True)
        if batch.num_vectors == 0 or k == 0:
            return _empty_result(q)
        k = min(int(k), batch.num_vectors)
        if prune:
            vals, idx = _pruned.fused_knn_l2_pruned_batch(
                _queries(q), batch.rows, batch.tile_summary(), k, norms2=batch.norms2())
        else:
            vals, idx = _kernels.fused_knn_l2_batch(_queries(q), batch.rows, k,
                                                    norms2=batch.norms2())
        return _result(q, vals, idx)


def batch_knn_dot(query, batch: VerticalBatch, k: int, prune: bool = False) -> BatchKnnResult:
    """Top-k by dot product — MIPS (reference ``src/batch.rs:731``).
    Scores descending; NaN scores sort first. ``prune=True``: the
    tile-skipping scan (see :func:`batch_knn`)."""
    with _trace.span("index.call"):
        with _trace.span("index.to_device"):
            q = _check_query(query, batch, "batch_knn_dot", allow_multi=True)
        if batch.num_vectors == 0 or k == 0:
            return _empty_result(q)
        k = min(int(k), batch.num_vectors)
        if prune:
            vals, idx = _pruned.fused_knn_dot_pruned_batch(
                _queries(q), batch.rows, batch.tile_summary(), k)
        else:
            vals, idx = _kernels.fused_knn_dot_batch(_queries(q), batch.rows, k)
        return _result(q, vals, idx)


def batch_knn_cosine(query, batch: VerticalBatch, k: int, prune: bool = False) -> BatchKnnResult:
    """Top-k by cosine similarity (reference ``src/batch.rs:766``). Scores
    descending; a zero-norm query scores everything 0.0; a NaN row scores
    NaN and sorts first (the JAX kernel paths' rule, ROADMAP R4).
    ``prune=True``: the tile-skipping scan over unit-row bounds (see
    :func:`batch_knn`)."""
    with _trace.span("index.call"):
        with _trace.span("index.to_device"):
            q = _check_query(query, batch, "batch_knn_cosine", allow_multi=True)
        if batch.num_vectors == 0 or k == 0:
            return _empty_result(q)
        k = min(int(k), batch.num_vectors)
        if prune:
            vals, idx = _pruned.fused_knn_cosine_pruned_batch(
                _queries(q), batch.rows, batch.tile_summary(normalized=True), k,
                inv=batch.inv_norms())
        else:
            vals, idx = _kernels.fused_knn_cosine_batch(
                _queries(q), batch.rows, k, inv=batch.inv_norms())
        return _result(q, vals, idx)


def batch_knn_filtered(query, batch: VerticalBatch, k: int, predicate) -> BatchKnnResult:
    """kNN by L2^2 with predicate pushdown (reference ``src/batch.rs:809``).

    ``predicate``: a callable ``index -> bool`` (evaluated on the host) or a
    boolean mask of length ``num_vectors``. Indices refer to the original
    batch; at most ``min(k, num_passing)`` results come back."""
    q = _check_query(query, batch, "batch_knn_filtered", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    if callable(predicate):
        mask = np.fromiter(
            (bool(predicate(i)) for i in range(batch.num_vectors)),
            dtype=bool, count=batch.num_vectors,
        )
        mask = torch.as_tensor(mask, device=batch.rows.device)
    else:
        mask = torch.as_tensor(predicate, dtype=torch.bool, device=batch.rows.device)
        if tuple(mask.shape) != (batch.num_vectors,):
            raise ContractError(
                f"innr_tpu_torch::batch_knn_filtered: mask shape {tuple(mask.shape)} "
                f"!= ({batch.num_vectors},)"
            )
    num_passing = int(mask.sum())
    if num_passing == 0:
        return _empty_result(q)
    # k <= num_passing: every selected row passes (failing rows sort after
    # every passing row, NaN included).
    k = min(int(k), num_passing)
    vals, idx = _kernels.fused_knn_l2_masked_batch(
        _queries(q), batch.rows, mask, k, norms2=batch.norms2()
    )
    return _result(q, vals, idx)


def batch_l2_squared_pruning(query, batch: VerticalBatch, threshold: float):
    """Indices and squared L2 distances of the vectors with L2^2 <=
    ``threshold`` (reference ``src/batch.rs:320``): ``(indices (M,) int64,
    distances (M,) float32)`` on the host, indices ascending.

    Runs the tile-skipping threshold scan: tiles whose centroid/radius lower
    bound exceeds the threshold are never read. Scores are ``norms2 - 2 q.r
    + ||q||^2``, so a row whose distance ties the threshold to the last ulp
    may fall either side of it under another summation order. On the card
    one kernel scores the live tiles and writes only the rows that pass,
    in order; one synchronisation reads their count and they alone are
    copied to the host. NaN distances are kept out."""
    q = _check_query(query, batch, "batch_l2_squared_pruning")
    if batch.num_vectors == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    idx, dists = _pruned.l2_squared_pruning_survivors(
        q, batch.rows, batch.norms2(), batch.tile_summary(), float(threshold))
    return idx.cpu().numpy(), dists.cpu().numpy()


def _variance_order(batch: VerticalBatch) -> torch.Tensor:
    """Dimensions by decreasing population variance, ties low dimension
    first."""
    keys = total_order_key_f32(batch_dimension_variance(batch))
    return torch.argsort(~keys, stable=True)


def batch_knn_reordered(query, batch: VerticalBatch, k: int) -> BatchKnnResult:
    """Exact kNN by L2^2 over the dimensions in decreasing variance order
    (reference ``src/batch.rs:610``): the same neighbors as
    :func:`batch_knn` up to float association. The permutation is applied
    for parity with the reference (it tightens the CPU reference's early
    exit; here it changes only the summation order), which costs a copy of
    the permuted corpus per call; the scan is the fused kNN kernel."""
    q = _check_query(query, batch, "batch_knn_reordered", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    order = _variance_order(batch)
    rows = batch.rows[:, order].contiguous()
    vals, idx = _kernels.fused_knn_l2_batch(_queries(q)[:, order].contiguous(), rows, k)
    return _result(q, vals, idx)


def _adaptive_plain(qs, rows, k: int, warmup_dims: int):
    """The warmup-extrapolation kNN of the JAX package (``_knn_adaptive``)
    in plain torch, over row chunks: ``(vals, idx, alive)``."""
    dim = rows.shape[1]
    scale = torch.tensor(dim, dtype=torch.float32) / torch.tensor(warmup_dims, dtype=torch.float32)
    step = max(1, (1 << 24) // max(1, qs.shape[0] * dim))

    def sq_dists(d_end):
        parts = []
        for s in range(0, rows.shape[0], step):
            diff = rows[None, s:s + step, :d_end].float() - qs[:, None, :d_end]
            parts.append((diff * diff).sum(dim=2))
        return torch.cat(parts, dim=1)

    partial = sq_dists(warmup_dims)
    kth, _ = top_k_total(partial, k, largest=False)
    threshold = kth[:, -1:] * scale.to(qs.device)
    # Inverted gates: NaN partials stay alive (reference src/batch.rs:474-488).
    alive = ~(partial * scale.to(qs.device) > threshold * 1.5)
    full = sq_dists(dim)
    alive &= ~(full > threshold)
    keys = torch.where(alive, ~total_order_key_f32(full), torch.iinfo(torch.int32).min)
    comp = composite_keys(keys, torch.arange(rows.shape[0], device=rows.device))
    idx = torch.topk(comp, k, dim=1).indices
    return torch.gather(full, 1, idx), idx, alive


def batch_knn_adaptive(query, batch: VerticalBatch, k: int, warmup_dims: int,
                       force_adaptive: bool = False) -> BatchKnnResult:
    """Adaptive kNN (reference ``src/batch.rs:439``), whose documented
    approximation contract only permits losing true neighbors.

    This package has no ``MIN_ROWS_PALLAS`` gate, so by default it returns
    the exact top-k of the tile-skipping scan (``batch_knn(...,
    prune=True)``: the tile kernel on a CUDA tensor, its plain version on
    the CPU) for every corpus size; ``warmup_dims`` is then validated and
    unused. For N < 2048 the JAX package runs the approximate warmup path
    there, so the port is exact where the reference is approximate; both
    meet the contract.

    ``force_adaptive=True``, or ``config.force_reference(True)``, runs the
    warmup-extrapolation path in plain torch: the first ``warmup_dims``
    dimensions extrapolate a threshold from the k-th best partial distance
    (x dim / warmup, x1.5 margin), then exact distances are kept where they
    pass it. It may return fewer than k results: a single query is
    trimmed; for a (Q, D) batch the tail entries carry index -1 and score
    NaN."""
    q = _check_query(query, batch, "batch_knn_adaptive", allow_multi=True)
    if warmup_dims <= 0:
        raise ContractError("innr_tpu_torch::batch_knn_adaptive: warmup_dims must be > 0")
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    warmup_dims = min(int(warmup_dims), batch.dimension)
    if not force_adaptive and not config.reference_forced():
        return batch_knn(q, batch, k, prune=True)
    vals, idx, alive = _adaptive_plain(_queries(q), batch.rows, k, warmup_dims)
    keep = torch.gather(alive, 1, idx)
    if q.dim() == 1:
        scores, indices = to_host(vals[0][keep[0]], idx[0][keep[0]])
    else:
        scores, indices = to_host(torch.where(keep, vals, torch.nan), torch.where(keep, idx, -1))
    return BatchKnnResult(indices=indices, scores=scores)
