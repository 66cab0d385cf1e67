"""Pluggable distance metrics (smaller = closer).

The counterpart of :mod:`innr_tpu.distance` (reference
``src/distance.rs``): a minimal metric protocol plus stateless metric
objects mirroring the ``anndists`` / ``hnsw_rs`` trait shape. Each metric's
``eval(a, b)`` returns a float32 distance; ``eval_batch(query, rows)`` is
the vectorized form over an (N, D) corpus, on :class:`VerticalBatch`,
:mod:`~innr_tpu_torch.ops.quant` and :mod:`~innr_tpu_torch.ops.slot`.
Results are float32 tensors on the corpus's device.
"""

from __future__ import annotations

import torch

from innr_tpu_torch.batch import VerticalBatch, batch_cosine, batch_dot, batch_l2_squared
from innr_tpu_torch.ops import dense, quant, slot
from innr_tpu_torch.utils.bits import as_unsigned
from innr_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "Distance",
    "DistCosine",
    "DistDot",
    "DistL2",
    "DistL1",
    "DistHamming",
    "DistSlotU32",
]


class Distance:
    """Metric protocol (reference ``src/distance.rs:66``): ``eval`` returns
    a distance, smaller meaning more similar."""

    def eval(self, a, b) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def eval_batch(self, query, rows) -> torch.Tensor:
        """Distances from one query to each row of an (N, D) corpus.
        Default: ``eval`` per row; subclasses override with batch forms."""
        return torch.stack([self.eval(query, r) for r in rows])


class DistCosine(Distance):
    """Cosine distance ``1 - cosine``; range [0, 2]
    (reference ``src/distance.rs:73``)."""

    def eval(self, a, b) -> torch.Tensor:
        return 1.0 - dense.cosine(a, b)

    def eval_batch(self, query, rows) -> torch.Tensor:
        return 1.0 - batch_cosine(query, VerticalBatch(rows))


class DistDot(Distance):
    """Negated dot product so larger inner products sort first
    (reference ``src/distance.rs:85``)."""

    def eval(self, a, b) -> torch.Tensor:
        return -dense.dot(a, b)

    def eval_batch(self, query, rows) -> torch.Tensor:
        return -batch_dot(query, VerticalBatch(rows))


class DistL2(Distance):
    """Euclidean distance (reference ``src/distance.rs:96``)."""

    def eval(self, a, b) -> torch.Tensor:
        return dense.l2_distance(a, b)

    def eval_batch(self, query, rows) -> torch.Tensor:
        return torch.sqrt(batch_l2_squared(query, VerticalBatch(rows)))


class DistL1(Distance):
    """Manhattan distance (reference ``src/distance.rs:107``)."""

    def eval(self, a, b) -> torch.Tensor:
        return dense.l1_distance(a, b)

    def eval_batch(self, query, rows) -> torch.Tensor:
        rows = as_tensor(rows, torch.float32)
        q = as_tensor(query, torch.float32, rows.device)
        return (rows - q[None, :]).abs().sum(dim=1)


class DistHamming(Distance):
    """Bit-Hamming over byte-packed binary vectors
    (reference ``src/distance.rs:119``)."""

    def eval(self, a, b) -> torch.Tensor:
        return quant.hamming_distance(a, b).to(torch.float32)

    def eval_batch(self, query, rows) -> torch.Tensor:
        return quant.batch_hamming(query, rows).to(torch.float32)


class DistSlotU32(Distance):
    """Normalized integer-slot Hamming (fraction of differing slots), the
    natural MinHash metric (reference ``src/distance.rs:136``)."""

    def eval(self, a, b) -> torch.Tensor:
        return slot.jaccard_distance(a, b)

    def eval_batch(self, query, rows) -> torch.Tensor:
        rows = as_unsigned(rows, 32)
        counts = slot.batch_slot_hamming_u32(query, rows)
        return counts.to(torch.float32) / float(rows.shape[1])
