"""2-D mesh composition: corpus sharding x query parallelism.

The counterpart of :mod:`innr_tpu.parallel.grid`. When both the corpus and
the query stream outgrow one device, the mesh factorises: axis
``"shards"`` splits the corpus rows (as
:class:`~innr_tpu_torch.parallel.sharded.ShardedCorpus`), axis
``"queries"`` the query batch (as
:class:`~innr_tpu_torch.parallel.query_parallel.QueryParallelIndex`). The
entry at (query group g, corpus shard c) scans g's query slice against
shard c on its own device, and candidates merge only along ``"shards"``:
the query groups never meet. Shard c is held once on each distinct device
of its column. Rows and query slices keep the JAX package's ranges without
its padding; an empty shard or slice is skipped.
"""

from __future__ import annotations

import numpy as np
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
    host_mask,
    host_rows,
    on_device,
    shard_ranges,
    visible_devices,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import merge_parts
from innr_tpu_torch.utils.tensors import empty_topk

__all__ = ["GridIndex", "grid_mesh"]

CORPUS_AXIS = "shards"
QUERY_AXIS = "queries"


def grid_mesh(corpus_shards: int, query_shards: int, devices=None) -> Mesh:
    """A (queries, shards) 2-D mesh over the first ``corpus_shards *
    query_shards`` of the given devices (default: every visible card; a
    device may repeat, e.g. ``["cuda:0"] * 4``)."""
    devices = np.asarray(visible_devices() if devices is None else list(devices),
                         dtype=object).reshape(-1)
    need = corpus_shards * query_shards
    if devices.size < need:
        raise ContractError(f"grid_mesh: need {need} devices, have {devices.size}")
    return Mesh(devices[:need].reshape(query_shards, corpus_shards), (QUERY_AXIS, CORPUS_AXIS))


class GridIndex:
    """An (N, D) corpus on a 2-D (queries x shards) mesh: rows split along
    ``"shards"``, query batches along ``"queries"``, top-k merged only
    across corpus shards. Methods take (Q, D) batches and return
    ``(scores (Q, k), global indices (Q, k))`` tensors on the mesh's first
    device."""

    def __init__(self, rows, mesh: Mesh, dtype=torch.float32):
        if set(mesh.axis_names) != {QUERY_AXIS, CORPUS_AXIS}:
            raise ContractError(
                f"GridIndex: mesh must have axes ({QUERY_AXIS!r}, {CORPUS_AXIS!r}) — build "
                f"one with grid_mesh()")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ContractError("GridIndex: dtype must be float32 or bfloat16")
        rows = host_rows(rows)
        if rows.ndim != 2:
            raise ContractError("GridIndex: rows must be 2-D (N, D)")
        self.mesh = mesh
        # The device grid as (query group, corpus shard), whatever the axis order.
        grid = mesh.devices if mesh.axis_names == (QUERY_AXIS, CORPUS_AXIS) else mesh.devices.T
        self._grid = grid
        self.n_shards = int(mesh.shape[CORPUS_AXIS])
        self.n_qgroups = int(mesh.shape[QUERY_AXIS])
        self.n_true = int(rows.shape[0])
        self._dim = int(rows.shape[1])
        self.ranges = shard_ranges(self.n_true, self.n_shards)
        # blocks[c][device]: shard c on each distinct device of its column.
        self.blocks = [{d: VerticalBatch(rows[s:e], dtype=dtype, device=d)
                        for d in dict.fromkeys(grid[:, c])}
                       for c, (s, e) in enumerate(self.ranges)]

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return self._dim

    def memory_bytes(self) -> int:
        """Bytes of every shard copy held (one per distinct device of its
        column; no padding rows)."""
        return sum(b.rows.numel() * b.rows.element_size()
                   for col in self.blocks for b in col.values())

    def _scan(self, qs, k: int, scan, avail):
        """Per non-empty query slice, ``scan(block, queries, k_c, base,
        device, c)`` over each shard c with ``avail[c]`` candidate rows (k_c
        = min(k, avail[c]); a shard with none is skipped), merged along the
        shards on the mesh's first device; raw ``(keys, idx)`` rows
        concatenated in query order, or None for an empty batch."""
        dev = self.mesh.flat()[0]
        n_q = int(qs.shape[0])
        keys_rows, idx_rows = [], []
        for g, (qa, qb) in enumerate(shard_ranges(n_q, self.n_qgroups)):
            if qb <= qa:
                continue
            parts = []
            for c, (s, _) in enumerate(self.ranges):
                if avail[c]:
                    d = self._grid[g, c]
                    with on_device(d):
                        q = qs[qa:qb].to(d, non_blocking=True)
                        parts.append(scan(self.blocks[c][d], q, min(k, avail[c]), s, d, c))
            keys, idx = merge_parts(parts, k, dev)
            keys_rows.append(keys)
            idx_rows.append(idx)
        if not keys_rows:
            return None
        return torch.cat(keys_rows), torch.cat(idx_rows)

    def _queries(self, queries, op: str):
        return as_queries(queries, self._dim, self.mesh.flat()[0], op, ranks=(2,))

    def _run(self, queries, k: int, mode: str, op: str):
        qs = self._queries(queries, op)
        n_q = int(qs.shape[0])
        if k <= 0 or self.n_true == 0:
            return empty_topk((n_q, 0), qs.device)
        k = min(int(k), self.n_true)
        if mode == "cosine":
            qs = _knn._unit_queries(qs)

        def scan(b, q, kc, base, d, c):
            return local_scan_keys(q, b.rows, aux_of(b, mode), self.n_true, kc, mode, base)

        out = self._scan(qs, k, scan, [e - s for s, e in self.ranges])
        if out is None:
            return empty_topk((0, k), qs.device)
        return _knn.decode_keys(out[0], mode, qs), out[1]

    def knn_dot(self, queries, k: int):
        """2-D-parallel MIPS: (Q, D) -> (scores (Q, k) descending, global
        indices)."""
        return self._run(queries, k, "dot", "grid_knn_dot")

    def knn_l2(self, queries, k: int):
        """2-D-parallel L2^2 kNN (ascending)."""
        return self._run(queries, k, "l2", "grid_knn_l2")

    def knn_cosine(self, queries, k: int):
        """2-D-parallel cosine kNN; zero-norm semantics as the single-device
        scan."""
        return self._run(queries, k, "cosine", "grid_knn_cosine")

    def knn_filtered(self, queries, k: int, predicate):
        """2-D-parallel predicate-pushdown L2^2 kNN: the (N,) global mask is
        cut along the corpus shards and pushed into each block's scan.
        ``predicate``: a boolean mask over global row indices, or a host
        callable ``index -> bool``. Returns at most ``min(k, num_passing)``
        results per query."""
        qs = self._queries(queries, "grid_knn_filtered")
        n, n_q = self.n_true, int(qs.shape[0])
        mask, num_passing = resolve_predicate_mask(predicate, n, "grid_knn_filtered")
        if k <= 0 or n == 0 or num_passing == 0:
            return empty_topk((n_q, 0), qs.device)
        k = min(int(k), num_passing)
        masks = {}

        def scan(b, q, kc, base, d, c):
            s, e = self.ranges[c]
            if (c, d) not in masks:
                masks[c, d] = host_mask(mask, s, e, d)
            return local_scan_keys_filtered(q, b.rows, b.norms2(), masks[c, d], n, kc, base)

        out = self._scan(qs, k, scan, [int(mask[s:e].sum()) for s, e in self.ranges])
        if out is None:
            return empty_topk((0, k), qs.device)
        return _knn.decode_keys(out[0], "l2", qs), out[1]
