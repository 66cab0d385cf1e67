"""Sharded asymmetric u8 search over a quantized corpus.

The counterpart of :mod:`innr_tpu.parallel.sharded_quant`. Codes shard
row-wise as uint8 (one byte a dimension on each device). Each shard runs
K1 over its codes (``csrc/knn.cu``: the codes widen in registers against
the query's hi/lo bf16 split, then an exact re-score) for the raw mixed
dot ``sum(q_i code_i)``; selection merges on those keys, and the affine
correction ``(alpha / 255) mixed + offset sum(q)`` applies once after the
merge (a per-query monotone map for alpha > 0, so it cannot change the
selection), with float32 constants as in the JAX package and
:func:`innr_tpu_torch.ops.scalar.batch_knn_u8_multi`.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.kernels.knn import decode_keys
from innr_tpu_torch.ops.scalar import QuantizationParams, _affine, _quantize
from innr_tpu_torch.parallel._scan import local_scan_keys
from innr_tpu_torch.parallel._stream import fetch_block
from innr_tpu_torch.parallel.sharded import (
    Mesh,
    as_queries,
    default_mesh,
    host_rows,
    on_device,
    per_device,
    shard_ranges,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import merge_parts
from innr_tpu_torch.utils.tensors import as_tensor, empty_topk

__all__ = ["ShardedQuantizedU8"]


class ShardedQuantizedU8:
    """A u8-quantized corpus sharded row-wise across a mesh: shard i is an
    (n_i, D) uint8 tensor on ``mesh.flat()[i]``."""

    def __init__(self, codes, params: QuantizationParams, mesh: Mesh | None = None):
        if not isinstance(codes, torch.Tensor):
            codes = np.asarray(codes, dtype=np.uint8)
        if codes.ndim != 2:
            raise ContractError("ShardedQuantizedU8: codes must be 2-D (N, D)")
        self._setup(params, mesh, int(codes.shape[0]), int(codes.shape[1]))
        self.shards = [as_tensor(codes[s:e], torch.uint8, d).contiguous()
                       for d, (s, e) in zip(self.mesh.flat(), self.ranges)]

    def _setup(self, params, mesh, n: int, d: int) -> None:
        self.params = params
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_true = n
        self._dim = d
        self.ranges = shard_ranges(n, self.mesh.size)

    @classmethod
    def quantize(cls, rows, params: QuantizationParams | None = None,
                 mesh: Mesh | None = None) -> "ShardedQuantizedU8":
        """Quantize an (N, D) f32 corpus shard by shard, each on its own
        device. Fits the parameters over the whole corpus (min / max of its
        float32 values) when not given."""
        rows = host_rows(rows)
        if rows.ndim != 2:
            raise ContractError("ShardedQuantizedU8.quantize: rows must be 2-D (N, D)")
        if params is None:
            params = QuantizationParams.fit(rows)
        self = cls.__new__(cls)
        self._setup(params, mesh, int(rows.shape[0]), int(rows.shape[1]))
        self.shards = [_quantize(as_tensor(rows[s:e], torch.float32, d), params.alpha,
                                 params.offset).contiguous()
                       for d, (s, e) in zip(self.mesh.flat(), self.ranges)]
        return self

    @classmethod
    def from_code_source(cls, get_codes, params: QuantizationParams, num_vectors: int,
                         dimension: int, mesh: Mesh | None = None) -> "ShardedQuantizedU8":
        """Stream a pre-quantized corpus in per-shard pieces (no host
        materialisation): ``get_codes(start, stop)`` returns code rows
        ``[start, stop)`` as ``(stop - start, D)`` uint8, e.g. a memmap
        over a ``quantize_u8_host`` file."""
        self = cls.__new__(cls)
        self._setup(params, mesh, int(num_vectors), int(dimension))
        name = "ShardedQuantizedU8.from_code_source"
        self.shards = [
            torch.from_numpy(fetch_block(get_codes, s, e, self._dim, np.uint8, name)
                             if e > s else np.zeros((0, self._dim), np.uint8)).to(d)
            for d, (s, e) in zip(self.mesh.flat(), self.ranges)]
        return self

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return self._dim

    def memory_bytes(self) -> int:
        return sum(c.numel() for c in self.shards)

    def knn(self, query, k: int):
        """Sharded asymmetric top-k: (D,) or (Q, D) f32 queries ->
        ``(scores descending, global indices)`` on the mesh's first device;
        scores carry the full affine correction."""
        q = as_queries(query, self._dim, self.mesh.flat()[0], "ShardedQuantizedU8.knn")
        if k <= 0 or self.n_true == 0:
            return empty_topk((0,) if q.dim() == 1 else (int(q.shape[0]), 0), q.device)
        k = min(int(k), self.n_true)
        qs = q if q.dim() == 2 else q[None, :]
        if qs.shape[0] == 0:
            return empty_topk((0, k), q.device)
        on = per_device(qs, self.mesh.flat())
        parts = []
        for d, (s, e), codes in zip(self.mesh.flat(), self.ranges, self.shards):
            if e > s:
                with on_device(d):
                    parts.append(local_scan_keys(on[d], codes, None, self.n_true,
                                                 min(k, e - s), "dot", s))
        keys, idx = merge_parts(parts, k, qs.device)
        vals = _affine(decode_keys(keys, "dot", qs), qs.sum(dim=1, keepdim=True), self.params)
        return (vals[0], idx[0]) if q.dim() == 1 else (vals, idx)
