"""Sharded retrieval over sparse (SPLADE-style) corpora.

The counterpart of :mod:`innr_tpu.parallel.sharded_sparse`. The padded
``(N, L)`` index / value arrays shard row-wise, each shard held in the
entry-major ``(L, n_i)`` layout of the sparse scan. Where the JAX package
joins every shard in XLA, each shard here runs K10 (``csrc/sparse_knn.cu``,
:func:`innr_tpu_torch.kernels.sparse_knn.fused_sparse_keys_batch`, any
query length), as :func:`innr_tpu_torch.ops.sparse.sparse_knn_batch` does
on one device, on queries sorted by index; the per-shard (f32 total-order
key, global index) pairs merge as in the dense family.

Sparse MaxSim has no kernel in either package: each shard scores on the
port's plain join (:func:`innr_tpu_torch.ops.sparse._corpus_maxsim_scores`)
with the query tokens sorted (F4), then selects and merges the same way.
"""

from __future__ import annotations

import torch

from innr_tpu_torch.kernels import sparse_knn as _sparse
from innr_tpu_torch.ops.sparse import (
    SparseCorpus,
    _as_padded_pair,
    _corpus_maxsim_scores,
    _parse_query_tokens,
    _query_pair,
    _sorted_queries,
    pad_sparse,
    pad_sparse_docs,
)
from innr_tpu_torch.parallel.sharded import (
    Mesh,
    default_mesh,
    local_top,
    on_device,
    per_device,
    shard_ranges,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import as_unsigned
from innr_tpu_torch.utils.order import invert_total_key, merge_parts
from innr_tpu_torch.utils.tensors import as_tensor, empty_topk

__all__ = ["ShardedSparseCorpus", "ShardedSparseMaxSimCorpus"]


def _holds_tensors(obj) -> bool:
    return isinstance(obj, tuple) and all(isinstance(t, torch.Tensor) for t in obj)


class ShardedSparseCorpus:
    """A padded sparse document corpus sharded row-wise across a mesh."""

    def __init__(self, docs, mesh: Mesh | None = None, width: int | None = None):
        """``docs``: a list of ``(indices, values)`` pairs, a pre-padded
        ``((N, L) idx, (N, L) val)`` tuple (tensors stay where they are;
        host data is padded on the host), or a :class:`SparseCorpus`."""
        if not isinstance(docs, SparseCorpus):
            docs = SparseCorpus(docs, width, device=None if _holds_tensors(docs) else "cpu")
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_true = docs.num_docs
        self._width = docs.width
        self.ranges = shard_ranges(self.n_true, self.mesh.size)
        # Entry-major (L, n_i) shards, the sparse scan's layout.
        self.shards = [(docs.indices[s:e].to(d).T.contiguous(),
                        docs.values[s:e].to(d).T.contiguous())
                       for d, (s, e) in zip(self.mesh.flat(), self.ranges)]

    @property
    def num_docs(self) -> int:
        return self.n_true

    @property
    def width(self) -> int:
        return self._width

    def memory_bytes(self) -> int:
        return sum(i.numel() * 8 for i, _ in self.shards)  # u32 index + f32 value

    def _run(self, q_idx, q_val, k: int, single: bool):
        n_q = int(q_idx.shape[0])
        if k <= 0 or self.n_true == 0:
            return empty_topk((0,) if single else (n_q, 0), q_idx.device)
        k = min(int(k), self.n_true)
        if n_q == 0:
            return empty_topk((0, k), q_idx.device)
        on_idx = per_device(q_idx, self.mesh.flat())
        on_val = per_device(q_val, self.mesh.flat())
        parts = []
        for d, (s, e), (idx_t, val_t) in zip(self.mesh.flat(), self.ranges, self.shards):
            if e > s:
                with on_device(d):
                    keys, lidx = _sparse.fused_sparse_keys_batch(on_idx[d], on_val[d], idx_t,
                                                                 val_t, min(k, e - s))
                    parts.append((keys, lidx + s))
        keys, idx = merge_parts(parts, k, q_idx.device)
        vals = invert_total_key(keys)
        return (vals[0], idx[0]) if single else (vals, idx)

    def knn(self, query, k: int):
        """Sharded top-k sparse dots for one ``(indices, values)`` query (any
        order; sorted here): ``(scores descending, global indices)``."""
        q_idx, q_val = _query_pair(query, "ShardedSparseCorpus.knn", self.mesh.flat()[0])
        if q_idx.dim() != 1:
            raise ContractError(
                "ShardedSparseCorpus.knn: query must be a 1-D (indices, values) pair; use "
                "knn_batch for batches")
        return self._run(q_idx[None, :], q_val[None, :], k, True)

    def knn_batch(self, queries, k: int):
        """Multi-query sharded sparse retrieval: a padded (Q, W) pair or a
        list of pairs -> ``(scores (Q, k), indices (Q, k))``, one launch per
        shard for the batch."""
        dev = self.mesh.flat()[0]
        pair = _as_padded_pair(queries, dev)
        q_idx, q_val = _sorted_queries(*(pair if pair is not None
                                         else pad_sparse(queries, device=dev)))
        if q_idx.dim() != 2:
            raise ContractError("ShardedSparseCorpus.knn_batch: queries must be 2-D")
        return self._run(q_idx, q_val, k, False)


class ShardedSparseMaxSimCorpus:
    """A padded sparse multi-vector document corpus sharded row-wise:
    sparse late interaction per shard, then the exact total-order merge."""

    def __init__(self, docs, mesh: Mesh | None = None):
        """``docs``: a list of documents (each a list of ``(indices,
        values)`` token pairs) or a pre-padded ``(idx, val, token_mask)``
        triple (:func:`~innr_tpu_torch.ops.sparse.pad_sparse_docs`)."""
        if isinstance(docs, tuple) and len(docs) == 3:
            dev = None if _holds_tensors(docs) else "cpu"
            idx = as_unsigned(docs[0], 32, dev)
            val = as_tensor(docs[1], torch.float32, idx.device)
            mask = as_tensor(docs[2], torch.bool, idx.device)
        else:
            idx, val, mask = pad_sparse_docs(docs, device="cpu")
        if idx.dim() != 3 or idx.shape != val.shape or mask.shape != idx.shape[:2]:
            raise ContractError(
                f"ShardedSparseMaxSimCorpus: bad padded shapes {tuple(idx.shape)} / "
                f"{tuple(val.shape)} / {tuple(mask.shape)}")
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_true = int(idx.shape[0])
        self.ranges = shard_ranges(self.n_true, self.mesh.size)
        self.shards = [(idx[s:e].to(d), val[s:e].to(d), mask[s:e].to(d))
                       for d, (s, e) in zip(self.mesh.flat(), self.ranges)]

    @property
    def num_docs(self) -> int:
        return self.n_true

    def memory_bytes(self) -> int:
        return sum(i.numel() * 8 + m.numel() for i, _, m in self.shards)

    def knn(self, query_tokens, k: int):
        """Sharded top-k documents by sparse MaxSim for one multi-vector
        query (a list of token pairs or a padded (Tq, W) pair; each token
        sorted by index here): ``(scores descending, global indices)``. An
        empty query scores every document 0.0."""
        dev = self.mesh.flat()[0]
        q_idx, q_val = _parse_query_tokens(query_tokens, dev)
        if k <= 0 or self.n_true == 0:
            return empty_topk((0,), dev)
        k = min(int(k), self.n_true)
        on_idx = per_device(q_idx, self.mesh.flat())
        on_val = per_device(q_val, self.mesh.flat())
        parts = []
        for d, (s, e), (d_idx, d_val, d_mask) in zip(self.mesh.flat(), self.ranges,
                                                      self.shards):
            if e > s:
                with on_device(d):
                    scores = _corpus_maxsim_scores(on_idx[d], on_val[d], d_idx, d_val, d_mask)
                    parts.append(local_top(scores[None, :], min(k, e - s), s))
        keys, idx = merge_parts(parts, k, dev)
        return invert_total_key(keys)[0], idx[0]
