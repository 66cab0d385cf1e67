"""Sparse primitives for learned sparse retrieval (tuple-based API).

The counterpart of :mod:`innr_tpu.ops.sparse_ext` (reference
``src/sparse_ext.rs``). A sparse vector is an ``(indices, values)`` pair or
a list of ``(dim, weight)`` tuples; indices are ``uint32`` held as
``int32`` views (:mod:`innr_tpu_torch.utils.bits`). Plain torch, plus numpy
where the JAX package uses numpy (:func:`sparse_top_k`'s stable
selection); no kernel. Host data goes to the default device (the card).

``sparse_dense_dot`` keeps the reference's safety contract: entries whose
dimension is out of bounds for the dense vector are skipped, decided for
every entry on its own (the true maximum, never a sortedness assumption;
reference ``src/sparse_ext.rs:190-202``).
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.ops.sparse import _sparse_dot_arrays
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import as_unsigned, unsigned_to_numpy
from innr_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "sparse_dot",
    "sparse_dense_dot",
    "sparse_l2_norm",
    "sparse_normalize",
    "sparse_top_k",
    "sparse_max_weight",
]


def _split(sv, name: str, device=None):
    """(indices, values) pairs or [(dim, w), ...] tuple lists -> (int32
    index view, float32 values)."""
    if isinstance(sv, tuple) and len(sv) == 2:
        idx = as_unsigned(sv[0], 32, device)
        val = as_tensor(sv[1], torch.float32, idx.device)
    else:
        entries = list(sv)
        idx = as_unsigned(np.array([int(d) for d, _ in entries], dtype=np.uint32), 32, device)
        val = as_tensor(np.array([float(w) for _, w in entries], dtype=np.float32),
                        torch.float32, idx.device)
    if idx.shape[-1] != val.shape[-1]:
        raise ContractError(
            f"sparse_ext::{name}: indices/values length mismatch "
            f"({idx.shape[-1]} vs {val.shape[-1]})")
    return idx, val


def sparse_dot(a, b) -> torch.Tensor:
    """Sparse x sparse dot, both sorted by dimension
    (reference ``src/sparse_ext.rs:16``)."""
    a_idx, a_val = _split(a, "sparse_dot")
    b_idx, b_val = _split(b, "sparse_dot", a_idx.device)
    return _sparse_dot_arrays(a_idx, a_val, b_idx, b_val)


def sparse_dense_dot(sparse, dense) -> torch.Tensor:
    """Sparse x dense dot with out-of-bounds entries skipped
    (reference ``src/sparse_ext.rs:65``). Unsorted input is safe: each
    entry's dimension is checked against ``len(dense)``."""
    idx, val = _split(sparse, "sparse_dense_dot")
    dense = as_tensor(dense, torch.float32, idx.device)
    if idx.shape[-1] == 0 or dense.shape[-1] == 0:
        return torch.tensor(0.0, dtype=torch.float32, device=idx.device)
    dims = idx.to(torch.int64) & 0xFFFFFFFF
    in_bounds = dims < dense.shape[-1]
    gathered = dense[torch.where(in_bounds, dims, 0)]
    return torch.where(in_bounds, val * gathered, 0.0).sum() + 0.0


def sparse_l2_norm(v) -> torch.Tensor:
    """L2 norm of the weights (reference ``src/sparse_ext.rs:151``)."""
    _, val = _split(v, "sparse_l2_norm")
    return torch.sqrt((val * val).sum())


def sparse_normalize(v) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit-normalized copy (functional; the reference mutates in place,
    ``src/sparse_ext.rs:156``). Zero-norm vectors are returned unchanged."""
    idx, val = _split(v, "sparse_normalize")
    n = torch.sqrt((val * val).sum())
    return idx, torch.where(n > 0.0, val / torch.where(n > 0.0, n, 1.0), val)


def sparse_top_k(v, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Keep the top-k entries by |weight|, re-sorted by dimension
    (reference ``src/sparse_ext.rs:167``): numpy ``(uint32 indices, float32
    values)``, as the JAX package returns."""
    idx, val = _split(v, "sparse_top_k")
    idx, val = unsigned_to_numpy(idx), val.detach().cpu().numpy()
    if val.size <= k:
        return idx, val
    # Stable descending-by-|w| selection, then re-sort by dimension.
    order = np.argsort(-np.abs(val), kind="stable")[:k]
    sel_idx, sel_val = idx[order], val[order]
    dim_order = np.argsort(sel_idx, kind="stable")
    return sel_idx[dim_order], sel_val[dim_order]


def sparse_max_weight(v) -> torch.Tensor:
    """Max weight folded from 0.0 (reference ``src/sparse_ext.rs:183``): an
    all-negative vector reports 0.0, by contract; NaN propagates."""
    _, val = _split(v, "sparse_max_weight")
    zero = torch.tensor(0.0, dtype=torch.float32, device=val.device)
    if val.shape[-1] == 0:
        return zero
    return torch.maximum(val.max(), zero)
