"""Sharded search over a slot-sketch (MinHash) corpus.

The counterpart of :mod:`innr_tpu.parallel.sharded_slot`. The corpus
shards **slot-major**: shard i holds the ``(S, n_i)`` transpose of its
sketches (uint32 slots as int32 views, or uint16 as int16, :mod:`innr_tpu_
torch.utils.bits`), the layout the slot scan streams. Each shard runs
K6/K7 (``csrc/slot_knn.cu``, :func:`innr_tpu_torch.kernels.slot_knn.
fused_slot_keys_batch`) at any k; the keys are the exact negated
differing-slot counts, so the shards merge exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.kernels import slot_knn as _slot
from innr_tpu_torch.ops.slot import _check_no_narrowing, _dtype_of, _similarities
from innr_tpu_torch.parallel._stream import column_major, fetch_block
from innr_tpu_torch.parallel.sharded import (
    Mesh,
    default_mesh,
    on_device,
    per_device,
    shard_ranges,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import as_unsigned, unsigned_bits
from innr_tpu_torch.utils.order import merge_parts

__all__ = ["ShardedSlotCorpus"]


def _bits_of(in_dtype, dtype) -> int:
    """The slot width: ``dtype``'s (16 or 32), else 16 for a 16-bit input
    and 32 for anything else."""
    if dtype is None:
        return 16 if unsigned_bits(in_dtype) == 16 else 32
    bits = unsigned_bits(dtype)
    if bits not in (16, 32):
        raise ContractError("ShardedSlotCorpus: dtype must be uint16 or uint32")
    return bits


class ShardedSlotCorpus:
    """A sketch corpus sharded sketch-wise (slot-major) across a mesh. Slots
    are uint32 by default; uint16 input (b = 16 b-bit MinHash) halves the
    bytes on each device."""

    def __init__(self, sketches, mesh: Mesh | None = None, dtype=None):
        in_dtype = _dtype_of(sketches)
        bits = _bits_of(in_dtype, dtype)
        _check_no_narrowing(in_dtype, bits, "ShardedSlotCorpus")
        if not isinstance(sketches, torch.Tensor):
            sketches = np.asarray(sketches)
        if sketches.ndim != 2:
            raise ContractError("ShardedSlotCorpus: sketches must be 2-D (N, S)")
        self._setup(mesh, sketches.shape[0], sketches.shape[1], bits)
        self.slots_t = [column_major(as_unsigned(sketches[s:e], bits, d))
                        for d, (s, e) in zip(self.mesh.flat(), self.ranges)]

    def _setup(self, mesh, n: int, s: int, bits: int) -> None:
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_true = int(n)
        self._num_slots = int(s)
        self.bits = bits
        self.ranges = shard_ranges(self.n_true, self.mesh.size)

    @classmethod
    def from_sketch_source(cls, get_sketches, num_sketches: int, num_slots: int,
                           mesh: Mesh | None = None, dtype=None) -> "ShardedSlotCorpus":
        """Stream a sketch corpus in per-shard pieces (no host
        materialisation): ``get_sketches(start, stop)`` returns sketches
        ``[start, stop)`` as ``(stop - start, S)`` uint32 (or uint16 with a
        16-bit ``dtype``)."""
        self = cls.__new__(cls)
        bits = 16 if dtype is not None and unsigned_bits(dtype) == 16 else 32
        self._setup(mesh, num_sketches, num_slots, bits)
        np_dtype = np.uint16 if bits == 16 else np.uint32
        name = "ShardedSlotCorpus.from_sketch_source"
        self.slots_t = [
            column_major(as_unsigned(
                fetch_block(get_sketches, s, e, self._num_slots, np_dtype, name) if e > s
                else np.zeros((0, self._num_slots), np_dtype), bits, d))
            for d, (s, e) in zip(self.mesh.flat(), self.ranges)]
        return self

    @property
    def num_sketches(self) -> int:
        return self.n_true

    @property
    def num_slots(self) -> int:
        return self._num_slots

    def memory_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.slots_t)

    def _check_q(self, q, op: str):
        _check_no_narrowing(_dtype_of(q), self.bits, f"ShardedSlotCorpus.{op}")
        q = as_unsigned(q, self.bits, self.mesh.flat()[0])
        if q.shape[-1] != self._num_slots:
            raise ContractError(
                f"ShardedSlotCorpus.{op}: query slots {q.shape[-1]} != corpus slots "
                f"{self._num_slots}")
        return q

    def _run(self, q, k: int):
        single = q.dim() == 1
        qs = q[None, :] if single else q
        if k <= 0 or self.n_true == 0 or qs.shape[0] == 0:
            k = 0 if k <= 0 or self.n_true == 0 else min(int(k), self.n_true)
            z = torch.zeros((0,) if single else (qs.shape[0], k), dtype=torch.int32,
                            device=q.device)
            return z, z.clone()
        k = min(int(k), self.n_true)
        on = per_device(qs.contiguous(), self.mesh.flat())
        parts = []
        for d, (s, e), slots_t in zip(self.mesh.flat(), self.ranges, self.slots_t):
            if e > s:
                with on_device(d):
                    keys, lidx = _slot.fused_slot_keys_batch(on[d], slots_t, min(k, e - s))
                    parts.append((keys, lidx + s))
        keys, idx = merge_parts(parts, k, qs.device)
        counts = -keys
        return (counts[0], idx[0]) if single else (counts, idx)

    def knn(self, query, k: int):
        """Sharded top-k smallest differing-slot counts for one (S,) sketch:
        ``(counts ascending, global indices)``."""
        q = self._check_q(query, "knn")
        if q.dim() != 1:
            raise ContractError(
                "ShardedSlotCorpus.knn: query must be 1-D (S,); use knn_batch for (Q, S) "
                "batches")
        return self._run(q, k)

    def knn_batch(self, queries, k: int):
        """Multi-query sharded slot kNN: (Q, S) sketches -> ``(counts (Q,
        k), indices (Q, k))``; one launch per shard for the whole batch."""
        q = self._check_q(queries, "knn_batch")
        if q.dim() != 2:
            raise ContractError("ShardedSlotCorpus.knn_batch: queries must be 2-D (Q, S)")
        return self._run(q, k)

    def minhash_knn(self, query, k: int):
        """Sharded MinHash retrieval: top-k Jaccard similarities (the
        matching-slot fraction, descending) and global indices."""
        counts, idx = self.knn(query, k)
        return _similarities(counts, self._num_slots), idx
