"""Sharded search over packed (binary / ternary) corpora.

The counterpart of :mod:`innr_tpu.parallel.sharded_packed`. Packed word
planes shard **word-major**: shard i holds the ``(W, n_i)`` int32
transpose of its rows (the JAX package's ``uint32`` words as bit-identical
int32 views, :mod:`innr_tpu_torch.utils.bits`), the layout the packed
scan streams, so each shard is a contiguous copy cut along N. Each shard
runs K2-K5 (``csrc/packed_knn.cu``, :func:`innr_tpu_torch.kernels.
packed_knn.fused_packed_keys_batch`) at any k: the JAX package's
``_plan_packed`` drops to XLA when ``k + pad`` exceeds one pass, while the
port's kernel runs every k in exclusion-bounded passes. Selection keys are
the exact integer counts (``-count`` for Hamming, the dot for ternary), so
the shards merge exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.kernels import packed_knn as _packed
from innr_tpu_torch.ops.binary import PackedBinary, encode_binary_batch
from innr_tpu_torch.ops.ternary import PackedTernary, encode_ternary_batch
from innr_tpu_torch.parallel._stream import column_major, fetch_block
from innr_tpu_torch.parallel.sharded import (
    Mesh,
    default_mesh,
    on_device,
    per_device,
    shard_ranges,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import as_words, mask_padding, num_words
from innr_tpu_torch.utils.order import merge_parts
from innr_tpu_torch.utils.tensors import as_tensor

__all__ = ["ShardedPackedBinary", "ShardedPackedTernary"]


def _empty(shape, dev):
    return (torch.zeros(shape, dtype=torch.int32, device=dev),
            torch.zeros(shape, dtype=torch.int32, device=dev))


def _host_or_tensor(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


class _ShardedPacked:
    """Shared layout and search of the packed containers: ``planes[i]`` is
    shard i's tuple of (W, n_i) word-major planes (one binary, two
    ternary) on ``mesh.flat()[i]``."""

    def _setup(self, mesh, n: int, dimension: int) -> None:
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_true = int(n)
        self._dimension = int(dimension)
        self.ranges = shard_ranges(self.n_true, self.mesh.size)

    def _cut(self, *planes_nw):
        """(N, W) planes (tensors or host arrays of uint32 words) -> each
        shard's masked word-major planes on its device."""
        self.planes = [
            tuple(column_major(mask_padding(as_words(p[s:e], d), self._dimension))
                  for p in planes_nw)
            for d, (s, e) in zip(self.mesh.flat(), self.ranges)]

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return self._dimension

    def memory_bytes(self) -> int:
        return sum(p.numel() * 4 for planes in self.planes for p in planes)

    def _search(self, queries, k: int):
        """``queries``: (Q, W) int32 planes on the mesh's first device ->
        merged ``(keys, global idx)`` (Q, k), larger keys better."""
        on = [per_device(q, self.mesh.flat()) for q in queries]
        parts = []
        for d, (s, e), planes in zip(self.mesh.flat(), self.ranges, self.planes):
            if e > s:
                with on_device(d):
                    keys, lidx = _packed.fused_packed_keys_batch(
                        tuple(q[d] for q in on), planes, min(k, e - s))
                    parts.append((keys, lidx + s))
        return merge_parts(parts, k, queries[0].device)

    def _query_planes(self, planes, op: str):
        dev = self.mesh.flat()[0]
        planes = tuple(as_words(p, dev) for p in planes)
        if (planes[0].dim() != 2 or planes[0].shape[1] != num_words(self._dimension)
                or any(p.shape != planes[0].shape for p in planes)):
            raise ContractError(
                f"{op}: query planes {[tuple(p.shape) for p in planes]} don't match dimension "
                f"{self._dimension}")
        return planes


class ShardedPackedBinary(_ShardedPacked):
    """A packed binary corpus sharded row-wise (word-major) across a mesh."""

    def __init__(self, words, dimension: int, mesh: Mesh | None = None):
        words = _host_or_tensor(words)
        if words.ndim != 2 or words.shape[1] != num_words(dimension):
            raise ContractError(
                f"ShardedPackedBinary: words shape {tuple(words.shape)} doesn't match "
                f"dimension {dimension}")
        self._setup(mesh, words.shape[0], dimension)
        self._cut(words)

    @classmethod
    def encode(cls, rows, threshold: float = 0.0, mesh: Mesh | None = None):
        """Encode an (N, D) f32 corpus (``x > threshold``) shard by shard,
        each on its own device."""
        rows = _host_or_tensor(rows)
        self = cls.__new__(cls)
        self._setup(mesh, rows.shape[0], rows.shape[1])
        self.planes = [
            (column_major(encode_binary_batch(as_tensor(rows[s:e], torch.float32, d),
                                              threshold)),)
            for d, (s, e) in zip(self.mesh.flat(), self.ranges)]
        return self

    @classmethod
    def from_word_source(cls, get_words, num_vectors: int, dimension: int,
                         mesh: Mesh | None = None) -> "ShardedPackedBinary":
        """Stream a packed corpus in per-shard pieces without host
        materialisation: ``get_words(start, stop)`` returns packed rows
        ``[start, stop)`` as ``(stop - start, W)`` uint32 (e.g. a memmap over
        an ``encode_binary_host`` file). The padding bits of the last word
        are masked here."""
        self = cls.__new__(cls)
        self._setup(mesh, num_vectors, dimension)
        w = num_words(dimension)
        name = "ShardedPackedBinary.from_word_source"
        self.planes = [
            (column_major(mask_padding(as_words(
                fetch_block(get_words, s, e, w, np.uint32, name) if e > s
                else np.zeros((0, w), np.uint32), d), self._dimension)),)
            for d, (s, e) in zip(self.mesh.flat(), self.ranges)]
        return self

    def _run(self, q_words, k: int, single: bool):
        if k <= 0 or self.n_true == 0 or q_words.shape[0] == 0:
            k = 0 if k <= 0 or self.n_true == 0 else min(int(k), self.n_true)
            return _empty((0,) if single else (q_words.shape[0], k), q_words.device)
        keys, idx = self._search((q_words,), min(int(k), self.n_true))
        counts = -keys
        return (counts[0], idx[0]) if single else (counts, idx)

    def knn(self, query: PackedBinary, k: int):
        """Sharded top-k smallest Hamming for one :class:`PackedBinary`:
        ``(counts ascending, global indices)``."""
        if query.dimension != self._dimension:
            raise ContractError(
                f"ShardedPackedBinary.knn: dimension mismatch ({query.dimension} vs "
                f"{self._dimension})")
        (q,) = self._query_planes((query.words[None, :],), "ShardedPackedBinary.knn")
        return self._run(q, k, True)

    def knn_batch(self, q_words, k: int):
        """Multi-query sharded Hamming top-k: (Q, W) packed queries ->
        ``(counts (Q, k), indices (Q, k))``; one launch per shard for the
        whole batch."""
        (q,) = self._query_planes((q_words,), "ShardedPackedBinary.knn_batch")
        return self._run(q, k, False)


class ShardedPackedTernary(_ShardedPacked):
    """An encoded ternary corpus sharded row-wise (word-major planes)."""

    def __init__(self, pos, neg, dimension: int, mesh: Mesh | None = None):
        pos, neg = _host_or_tensor(pos), _host_or_tensor(neg)
        if pos.ndim != 2 or tuple(pos.shape) != tuple(neg.shape) or (
                pos.shape[1] != num_words(dimension)):
            raise ContractError(
                f"ShardedPackedTernary: plane shapes {tuple(pos.shape)}/{tuple(neg.shape)} "
                f"don't match dimension {dimension}")
        self._setup(mesh, pos.shape[0], dimension)
        self._cut(pos, neg)

    @classmethod
    def encode(cls, rows, threshold: float, mesh: Mesh | None = None):
        """Encode an (N, D) f32 corpus shard by shard, each on its own
        device."""
        rows = _host_or_tensor(rows)
        self = cls.__new__(cls)
        self._setup(mesh, rows.shape[0], rows.shape[1])
        self.planes = [tuple(column_major(p) for p in encode_ternary_batch(
                           as_tensor(rows[s:e], torch.float32, d), threshold))
                       for d, (s, e) in zip(self.mesh.flat(), self.ranges)]
        return self

    def _run(self, planes, k: int, single: bool):
        n_q = planes[0].shape[0]
        if k <= 0 or self.n_true == 0 or n_q == 0:
            k = 0 if k <= 0 or self.n_true == 0 else min(int(k), self.n_true)
            return _empty((0,) if single else (n_q, k), planes[0].device)
        dots, idx = self._search(planes, min(int(k), self.n_true))
        return (dots[0], idx[0]) if single else (dots, idx)

    def knn(self, query: PackedTernary, k: int):
        """Sharded top-k largest ternary dots for one :class:`PackedTernary`:
        ``(dots descending, global indices)``."""
        if query.dimension != self._dimension:
            raise ContractError(
                f"ShardedPackedTernary.knn: dimension mismatch ({query.dimension} vs "
                f"{self._dimension})")
        planes = self._query_planes((query.pos[None, :], query.neg[None, :]),
                                    "ShardedPackedTernary.knn")
        return self._run(planes, k, True)

    def knn_batch(self, queries, k: int):
        """Multi-query sharded ternary top-k. ``queries``: a ``((Q, W) pos,
        (Q, W) neg)`` plane tuple (e.g. from ``encode_ternary_batch``).
        Returns ``(dots (Q, k), indices)``."""
        planes = self._query_planes((queries[0], queries[1]),
                                    "ShardedPackedTernary.knn_batch")
        return self._run(planes, k, False)
