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
on a CUDA device, or its plain version for a corpus on the CPU. The
tile-pruned scans (``prune=True``, ``batch_knn_reordered``,
``batch_knn_adaptive``, ``batch_l2_squared_pruning``) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from innr_tpu_torch.config import NORM_EPSILON
from innr_tpu_torch.kernels import knn as _kernels
from innr_tpu_torch.utils.asserts import ContractError

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
    ``device`` (default CPU); a tensor stays on its device unless
    ``device`` is given.
    """

    __slots__ = ("rows", "_norms2", "_inv_norms")

    def __init__(self, rows, dtype=torch.float32, device=None):
        if dtype not in _DTYPES:
            raise ContractError("VerticalBatch: dtype must be float32 or bfloat16")
        if isinstance(rows, torch.Tensor):
            rows = rows.to(device=device if device is not None else rows.device, dtype=dtype)
        else:
            arr = np.asarray(rows)
            if arr.dtype.name == "bfloat16":
                rows = _bf16_from_numpy(arr).to(device=device or "cpu", dtype=dtype)
            else:
                rows = torch.as_tensor(
                    np.asarray(arr, dtype=np.float32), device=device or "cpu"
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
    return BatchKnnResult(
        indices=idx.cpu().numpy().astype(np.int64),
        scores=vals.cpu().numpy().astype(np.float32),
    )


def _queries(q) -> torch.Tensor:
    return q if q.dim() == 2 else q[None, :]


def batch_knn(query, batch: VerticalBatch, k: int) -> BatchKnnResult:
    """Exact k nearest neighbors by squared L2 (reference ``src/batch.rs:385``).
    Scores ascending; k is capped at N."""
    q = _check_query(query, batch, "batch_knn", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    vals, idx = _kernels.fused_knn_l2_batch(_queries(q), batch.rows, k, norms2=batch.norms2())
    return _result(q, vals, idx)


def batch_knn_dot(query, batch: VerticalBatch, k: int) -> BatchKnnResult:
    """Top-k by dot product — MIPS (reference ``src/batch.rs:731``).
    Scores descending; NaN scores sort first."""
    q = _check_query(query, batch, "batch_knn_dot", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    vals, idx = _kernels.fused_knn_dot_batch(_queries(q), batch.rows, k)
    return _result(q, vals, idx)


def batch_knn_cosine(query, batch: VerticalBatch, k: int) -> BatchKnnResult:
    """Top-k by cosine similarity (reference ``src/batch.rs:766``). Scores
    descending; a zero-norm query scores everything 0.0."""
    q = _check_query(query, batch, "batch_knn_cosine", allow_multi=True)
    if batch.num_vectors == 0 or k == 0:
        return _empty_result(q)
    k = min(int(k), batch.num_vectors)
    vals, idx = _kernels.fused_knn_cosine_batch(
        _queries(q), batch.rows, k, inv=batch.inv_norms()
    )
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
