"""Sharded MaxSim (late-interaction) retrieval over a multi-vector corpus.

The counterpart of :mod:`innr_tpu.parallel.sharded_maxsim`. Documents
shard row-wise as (n_i, Td, D) tensors (row slices of a tensor on the
shard's device are views) with their token masks; each shard scores its
documents with K11/K12 (``csrc/maxsim.cu`` for float32 documents,
``csrc/maxsim_bf16.cu`` for bfloat16: :func:`innr_tpu_torch.kernels.
maxsim_kernel.fused_maxsim_scores_batch`), selects its top-k by
total-order key of the canonical-NaN scores, and the (key, global index)
candidates merge on the mesh's first device, as
:func:`innr_tpu_torch.ops.maxsim.maxsim_knn_batch` selects on one device.
"""

from __future__ import annotations

import torch

from innr_tpu_torch.kernels.maxsim_kernel import fused_maxsim_scores_batch
from innr_tpu_torch.parallel.sharded import (
    Mesh,
    as_queries,
    default_mesh,
    local_top,
    on_device,
    per_device,
    shard_ranges,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import canonical_nan, invert_total_key, merge_parts
from innr_tpu_torch.utils.tensors import as_tensor, empty_topk

__all__ = ["ShardedMaxSimCorpus"]


class ShardedMaxSimCorpus:
    """An (N, Td, D) multi-vector corpus sharded row-wise across a mesh.

    ``doc_mask`` (N, Td) marks real tokens in ragged documents; padded
    documents and tokens are left out exactly (an empty document scores
    0.0). ``dtype=torch.bfloat16`` stores the documents in half precision
    (the bf16 scan, scored against the bf16-rounded queries); the JAX class
    is float32 only."""

    def __init__(self, docs, doc_mask=None, mesh: Mesh | None = None, dtype=torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ContractError("ShardedMaxSimCorpus: dtype must be float32 or bfloat16")
        docs = docs if isinstance(docs, torch.Tensor) else as_tensor(docs, torch.float32, "cpu")
        if docs.dim() != 3:
            raise ContractError("ShardedMaxSimCorpus: docs must be 3-D (N, Td, D)")
        if doc_mask is not None:
            doc_mask = (doc_mask if isinstance(doc_mask, torch.Tensor)
                        else as_tensor(doc_mask, torch.bool, "cpu"))
            if tuple(doc_mask.shape) != tuple(docs.shape[:2]):
                raise ContractError(
                    f"ShardedMaxSimCorpus: doc_mask shape {tuple(doc_mask.shape)} != "
                    f"{tuple(docs.shape[:2])}")
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_true = int(docs.shape[0])
        self._dim = int(docs.shape[2])
        self.ranges = shard_ranges(self.n_true, self.mesh.size)
        self.docs = [docs[s:e].to(device=d, dtype=dtype).contiguous()
                     for d, (s, e) in zip(self.mesh.flat(), self.ranges)]
        self.masks = [None if doc_mask is None else
                      doc_mask[s:e].to(device=d, dtype=torch.bool).contiguous()
                      for d, (s, e) in zip(self.mesh.flat(), self.ranges)]

    @property
    def num_docs(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return self._dim

    def memory_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.docs) + sum(
            m.numel() for m in self.masks if m is not None)

    def knn(self, query_tokens, k: int):
        """Sharded top-k documents by MaxSim. ``query_tokens``: one (Tq, D)
        token matrix or a (B, Tq, D) batch (each shard scores the whole
        batch in one launch). Returns ``(scores descending, global
        indices)`` on the mesh's first device."""
        q = as_queries(query_tokens, self._dim, self.mesh.flat()[0], "ShardedMaxSimCorpus.knn",
                       ranks=(2, 3))
        single = q.dim() == 2
        qs = q[None] if single else q
        if k <= 0 or self.n_true == 0 or qs.shape[1] == 0 or qs.shape[0] == 0:
            k = 0 if k <= 0 or self.n_true == 0 or qs.shape[1] == 0 else min(int(k), self.n_true)
            return empty_topk((0,) if single else (int(qs.shape[0]), k), q.device)
        k = min(int(k), self.n_true)
        on = per_device(qs, self.mesh.flat())
        parts = []
        for d, (s, e), docs, mask in zip(self.mesh.flat(), self.ranges, self.docs, self.masks):
            if e > s:
                with on_device(d):
                    scores = fused_maxsim_scores_batch(on[d], docs, mask)
                    parts.append(local_top(canonical_nan(scores), min(k, e - s), s))
        keys, idx = merge_parts(parts, k, qs.device)
        vals = invert_total_key(keys)
        return (vals[0], idx[0]) if single else (vals, idx)
