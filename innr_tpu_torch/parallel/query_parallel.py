"""Query-parallel kNN: split the QUERY batch across the mesh, replicate the
corpus.

The counterpart of :mod:`innr_tpu.parallel.query_parallel`, the complement
of :class:`~innr_tpu_torch.parallel.sharded.ShardedCorpus`: when the
corpus fits one device but the query stream is large, each mesh entry
scans its slice of the queries against the corpus replica on its device,
and the rows of the results concatenate in query order with no merge (each
query's top-k is complete on its device). The replica is held once per
distinct device, not once per mesh entry. Query slices keep the JAX
package's sizes (``ceil(Q / entries)``) without its padding queries; an
empty slice is skipped. Results equal the single-device scan bit for bit
(same kernel, same corpus).
"""

from __future__ import annotations

import torch

from innr_tpu_torch.batch import VerticalBatch
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.parallel._scan import (
    local_scan_keys,
    local_scan_keys_filtered,
    resolve_predicate_mask,
)
from innr_tpu_torch.parallel.sharded import (
    Mesh,
    as_queries,
    aux_of,
    default_mesh,
    host_mask,
    host_rows,
    on_device,
    shard_ranges,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.tensors import empty_topk

__all__ = ["QueryParallelIndex"]


class QueryParallelIndex:
    """A replicated (N, D) corpus serving query batches split across the
    mesh. ``knn_dot`` / ``knn_l2`` / ``knn_cosine`` / ``knn_filtered`` take
    (Q, D) batches and return ``(scores (Q, k), indices (Q, k))`` tensors on
    the mesh's first device."""

    def __init__(self, rows, mesh: Mesh | None = None, dtype=torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ContractError("QueryParallelIndex: dtype must be float32 or bfloat16")
        rows = host_rows(rows)
        if rows.ndim != 2:
            raise ContractError("QueryParallelIndex: rows must be 2-D (N, D)")
        self.mesh = mesh if mesh is not None else default_mesh()
        self.replicas = {d: VerticalBatch(rows, dtype=dtype, device=d)
                         for d in self.mesh.distinct()}
        self._first = self.replicas[self.mesh.flat()[0]]

    @property
    def num_vectors(self) -> int:
        return self._first.num_vectors

    @property
    def dimension(self) -> int:
        return self._first.dimension

    def memory_bytes(self) -> int:
        """One replica's footprint: its rows and any norm cache made."""
        b = self._first
        total = b.rows.numel() * b.rows.element_size()
        for aux in (b._norms2, b._inv_norms):
            if aux is not None:
                total += aux.numel() * 4
        return total

    def _slices(self, qs):
        """``(device, replica, query slice, start, stop)`` of each non-empty
        slice of the batch."""
        for d, (s, e) in zip(self.mesh.flat(), shard_ranges(qs.shape[0], self.mesh.size)):
            if e > s:
                yield d, self.replicas[d], qs[s:e].to(d, non_blocking=True), s, e

    def _gather(self, parts, n_q: int, k: int):
        dev = self.mesh.flat()[0]
        if not parts:
            return empty_topk((n_q, k), dev)
        vals = torch.cat([v.to(dev, non_blocking=True) for v, _ in parts])
        idx = torch.cat([i.to(dev, non_blocking=True) for _, i in parts])
        return vals, idx

    def _queries(self, queries, op: str):
        return as_queries(queries, self.dimension, self.mesh.flat()[0], op, ranks=(2,))

    def _run(self, queries, k: int, mode: str, op: str):
        qs = self._queries(queries, op)
        n, n_q = self.num_vectors, int(qs.shape[0])
        if k <= 0 or n == 0:
            return empty_topk((n_q, 0), qs.device)
        k = min(int(k), n)
        if mode == "cosine":
            qs = _knn._unit_queries(qs)
        parts = []
        for d, b, q, _, _ in self._slices(qs):
            with on_device(d):
                keys, idx = local_scan_keys(q, b.rows, aux_of(b, mode), n, k, mode)
                parts.append((_knn.decode_keys(keys, mode, q), idx))
        return self._gather(parts, n_q, k)

    def knn_dot(self, queries, k: int):
        """Query-parallel MIPS: (Q, D) -> (scores (Q, k) descending,
        indices)."""
        return self._run(queries, k, "dot", "query_parallel_knn_dot")

    def knn_l2(self, queries, k: int):
        """Query-parallel L2^2 kNN: distances ascending."""
        return self._run(queries, k, "l2", "query_parallel_knn_l2")

    def knn_cosine(self, queries, k: int):
        """Query-parallel cosine kNN; zero-norm semantics as the
        single-device scan."""
        return self._run(queries, k, "cosine", "query_parallel_knn_cosine")

    def knn_filtered(self, queries, k: int, predicate):
        """Query-parallel predicate-pushdown L2^2 kNN: the (N,) mask is held
        beside each replica; queries split. ``predicate``: a boolean mask
        over row indices, or a host callable ``index -> bool``. Returns at
        most ``min(k, num_passing)`` results per query."""
        qs = self._queries(queries, "query_parallel_knn_filtered")
        n, n_q = self.num_vectors, int(qs.shape[0])
        mask, num_passing = resolve_predicate_mask(predicate, n, "query_parallel_knn_filtered")
        if k <= 0 or n == 0 or num_passing == 0:
            return empty_topk((n_q, 0), qs.device)
        k = min(int(k), num_passing)
        masks = {}
        parts = []
        for d, b, q, _, _ in self._slices(qs):
            with on_device(d):
                if d not in masks:
                    masks[d] = host_mask(mask, 0, n, d)
                keys, idx = local_scan_keys_filtered(q, b.rows, b.norms2(), masks[d], n, k)
                parts.append((_knn.decode_keys(keys, "l2", q), idx))
        return self._gather(parts, n_q, k)
