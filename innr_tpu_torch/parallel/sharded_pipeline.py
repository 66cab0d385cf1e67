"""Sharded two-stage retrieval: a per-shard coarse scan and exact rerank,
then one global merge.

The counterpart of :mod:`innr_tpu.parallel.sharded_pipeline`, the
mesh-scale form of :class:`innr_tpu_torch.pipeline.TwoStageIndex`. The f32
rows and the coarse representation shard alike (the JAX package's row
ranges without its padding); each shard runs the whole pipeline over its
own rows on its own device, with the single-device index's steps
(:func:`innr_tpu_torch.pipeline.coarse_candidates` on K1 for u8 and
matryoshka or K2-K5 for binary and ternary, then
:func:`innr_tpu_torch.pipeline.rerank`), and only the exact (score, global
index) top-k of each shard reaches the merge.

Recall contract: each shard shortlists ``min(max(k * rerank_factor, k),
shard_rows)`` of its own rows, so results depend on the shard count; a
one-shard mesh shortlists as the single-device index does. u8 parameters
are fitted over the whole corpus. The merge keeps the JAX package's order
for equal scores: shard order, then each shard's rerank order.
"""

from __future__ import annotations

import torch

from innr_tpu_torch.pipeline import (
    CoarseConfig,
    build_coarse,
    coarse_candidates,
    fit_params,
    rerank,
)
from innr_tpu_torch.parallel.sharded import (
    Mesh,
    as_queries,
    default_mesh,
    host_rows,
    on_device,
    per_device,
    shard_ranges,
    shard_rows_of,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import top_k_total
from innr_tpu_torch.utils.tensors import as_tensor, empty_topk

__all__ = ["ShardedTwoStageIndex"]


class ShardedTwoStageIndex:
    """Coarse-quantized scan + exact rerank over a row-sharded corpus."""

    def __init__(self, rows, coarse: CoarseConfig | str = "binary", rerank_factor: int = 4,
                 mesh: Mesh | None = None):
        if isinstance(coarse, str):
            coarse = CoarseConfig(kind=coarse)
        if coarse.kind not in ("binary", "ternary", "u8", "matryoshka"):
            raise ContractError(f"ShardedTwoStageIndex: unknown coarse kind {coarse.kind!r}")
        self.config = coarse
        self.rerank_factor = int(rerank_factor)
        if self.rerank_factor < 1:
            raise ContractError("ShardedTwoStageIndex: rerank_factor must be >= 1")
        rows = host_rows(rows)
        if rows.ndim != 2:
            raise ContractError("ShardedTwoStageIndex: rows must be 2-D (N, D)")
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_true = int(rows.shape[0])
        self._dim = int(rows.shape[1])
        self.ranges = shard_ranges(self.n_true, self.mesh.size)
        if coarse.kind == "u8":
            self.params = fit_params(coarse, rows)
        self.rows = [as_tensor(rows[s:e], torch.float32, d).contiguous()
                     for d, (s, e) in zip(self.mesh.flat(), self.ranges)]
        self._coarse = [build_coarse(coarse, r, getattr(self, "params", None),
                                     "ShardedTwoStageIndex") for r in self.rows]

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return self._dim

    def memory_bytes(self) -> dict:
        """Bytes of the f32 rows and of the coarse representation held."""
        kind = self.config.kind
        fine = sum(r.numel() * 4 for r in self.rows)
        if kind == "matryoshka":
            coarse = sum(c.numel() * 4 for c in self._coarse)
        else:
            coarse = sum(c.memory_bytes() for c in self._coarse)
        return {"fine_f32": fine, f"coarse_{kind}": coarse}

    def search(self, query, k: int):
        """Single-query sharded two-stage search -> ``(scores descending,
        global indices)``."""
        q = as_queries(query, self._dim, self.mesh.flat()[0], "ShardedTwoStageIndex.search",
                       ranks=(1,))
        vals, idx = self.search_batch(q[None, :], k)
        return vals[0], idx[0]

    def search_batch(self, queries, k: int):
        """(Q, D) queries -> exact-scored ``(scores (Q, k), global indices
        (Q, k))`` on the mesh's first device."""
        qs = as_queries(queries, self._dim, self.mesh.flat()[0],
                        "ShardedTwoStageIndex.search_batch", ranks=(2,))
        n_q = int(qs.shape[0])
        if self.n_true == 0 or k == 0 or n_q == 0:
            return empty_topk((n_q, 0), qs.device)
        k = min(int(k), self.n_true)
        # Per-shard shortlist of the JAX package's size, cut to the shard.
        n_cand = min(max(k * self.rerank_factor, k),
                     shard_rows_of(self.n_true, self.mesh.size))
        on = per_device(qs, self.mesh.flat())
        vals, idx = [], []
        for d, (s, e), rows, coarse in zip(self.mesh.flat(), self.ranges, self.rows,
                                           self._coarse):
            if e > s:
                c = min(n_cand, e - s)
                with on_device(d):
                    _, cand = coarse_candidates(self.config, coarse, on[d], c)
                    v, i = rerank(rows, on[d], cand, min(k, c))
                    vals.append(v.to(qs.device, non_blocking=True))
                    idx.append((i + s).to(qs.device, non_blocking=True))
        vals, pos = top_k_total(torch.cat(vals, 1), k, largest=True)
        return vals, torch.gather(torch.cat(idx, 1), 1, pos).to(torch.int32)
