"""Ternary (1.58-bit) quantization: {-1, 0, +1} vectors as two bitplanes.

The counterpart of :mod:`innr_tpu.ops.ternary` (reference
``src/ternary.rs``). A vector is two packed planes of 32-bit words: ``pos``
(value +1) and ``neg`` (value -1), never both at one position. The JAX
package's ``uint32`` planes are held here as bit-identical int32
(:mod:`innr_tpu_torch.utils.bits`); ``from_numpy`` takes them as they are,
and ``from_interleaved_u64`` / ``to_interleaved_u64`` keep the reference's
2-bit interleaved serialization.

Inner product: ``popcount(same-sign) - popcount(opposite-sign)``. The
scans run on hand-written CUDA kernels for a corpus on a CUDA device and on
their plain versions for a corpus on the CPU: ``ternary_knn`` /
``ternary_knn_batch`` on ``packed_scan``
(:mod:`innr_tpu_torch.kernels.packed_knn`), ``batch_ternary_dot`` on
``packed_rows`` (:mod:`innr_tpu_torch.kernels.hamming`). Any k runs in the
kernel (exclusion-bounded passes); the results equal the JAX package's.

Return types: scalar and per-row integer ops return int32 tensors (the JAX
``ternary_hamming`` returns uint32; the values are equal); ``ternary_knn``
and ``ternary_knn_batch`` return numpy ``(int32 dots, int64 indices)`` as
the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.kernels import hamming as _hamming
from innr_tpu_torch.kernels import packed_knn as _packed
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.bits import (
    as_words,
    bit_value,
    f32_threshold,
    mask_padding,
    num_words,
    pack_bits,
    popcount32,
    unpack_bits,
    word_scores,
)
from innr_tpu_torch.utils.tensors import as_tensor, host_device

__all__ = [
    "PackedTernary",
    "PackedTernaryBatch",
    "encode_ternary",
    "encode_ternary_values",
    "encode_ternary_batch",
    "ternary_dot",
    "ternary_hamming",
    "asymmetric_dot",
    "sparsity",
    "batch_ternary_dot",
    "batch_asymmetric_dot",
    "ternary_knn",
    "ternary_knn_batch",
]


class PackedTernary:
    """A packed ternary vector as two (W,) int32 bitplanes (reference
    ``src/ternary.rs:57``). A position set in both planes (the reference's
    reserved ``11`` pattern) raises :class:`ContractError`."""

    __slots__ = ("pos", "neg", "_dimension")

    def __init__(self, pos, neg, dimension: int, device=None):
        pos = as_words(pos, device)
        neg = as_words(neg, pos.device)
        w = num_words(dimension)
        if tuple(pos.shape) != (w,) or tuple(neg.shape) != (w,):
            raise ContractError(
                f"PackedTernary: plane lengths {tuple(pos.shape)}/{tuple(neg.shape)} "
                f"don't match dimension {dimension} (expected {w} words)"
            )
        pos = mask_padding(pos, dimension)
        neg = mask_padding(neg, dimension)
        if bool(((pos & neg) != 0).any()):
            raise ContractError(
                "PackedTernary: a position is set in both planes "
                "(the reserved '11' pattern)"
            )
        self.pos = pos
        self.neg = neg
        self._dimension = int(dimension)

    @property
    def dimension(self) -> int:
        return self._dimension

    @classmethod
    def zeros(cls, dimension: int, device=None) -> "PackedTernary":
        z = torch.zeros(num_words(dimension), dtype=torch.int32, device=host_device(device))
        return cls(z, z, dimension)

    @classmethod
    def from_numpy(cls, pos, neg, dimension: int, device=None) -> "PackedTernary":
        """From (W,) uint32 planes, e.g. ``np.asarray`` of an ``innr_tpu``
        vector's ``pos`` and ``neg``."""
        return cls(np.asarray(pos, dtype=np.uint32), np.asarray(neg, dtype=np.uint32),
                   dimension, device)

    @classmethod
    def from_interleaved_u64(cls, data, dimension: int, device=None) -> "PackedTernary":
        """Build from the reference's 2-bit-interleaved u64 words (bits
        ``2i..2i+2`` encode value i: 01 = +1, 10 = -1)."""
        words = np.asarray(data, dtype=np.uint64)
        i = np.arange(dimension)
        pairs = (words[i // 32] >> ((i % 32) * 2).astype(np.uint64)) & np.uint64(0b11)
        vals = np.where(pairs == 0b01, 1, np.where(pairs == 0b10, -1, 0))
        return encode_ternary_values(vals, device)

    def data(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The raw (pos, neg) int32 bitplanes."""
        return self.pos, self.neg

    def to_interleaved_u64(self) -> np.ndarray:
        """Serialize to the reference's interleaved u64 layout
        (``src/ternary.rs:91``)."""
        vals = self.to_values().cpu().numpy()
        pairs = np.where(vals > 0, 0b01, np.where(vals < 0, 0b10, 0)).astype(np.uint64)
        i = np.arange(self._dimension)
        out = np.zeros((-(-self._dimension // 32),), dtype=np.uint64)
        np.bitwise_or.at(out, i // 32, pairs << ((i % 32) * 2).astype(np.uint64))
        return out

    def set(self, idx: int, val: int) -> "PackedTernary":
        """A copy with position ``idx`` set to the sign of ``val``;
        out-of-range indices are ignored, as in the reference."""
        if not 0 <= idx < self._dimension:
            return self
        word, bit = divmod(idx, 32)
        pos, neg = self.pos.clone(), self.neg.clone()
        pos[word] &= ~bit_value(bit)
        neg[word] &= ~bit_value(bit)
        if val > 0:
            pos[word] |= bit_value(bit)
        elif val < 0:
            neg[word] |= bit_value(bit)
        return PackedTernary(pos, neg, self._dimension)

    def get(self, idx: int) -> int:
        if not 0 <= idx < self._dimension:
            return 0
        word, bit = divmod(idx, 32)
        if (int(self.pos[word]) >> bit) & 1:
            return 1
        if (int(self.neg[word]) >> bit) & 1:
            return -1
        return 0

    def nnz(self) -> int:
        return int(popcount32(self.pos | self.neg).sum())

    def memory_bytes(self) -> int:
        """Backing storage: two planes of 4-byte words (2 bits a value)."""
        return int(self.pos.shape[0] + self.neg.shape[0]) * 4

    def to_values(self) -> torch.Tensor:
        """Unpack to a (dimension,) int8 tensor of {-1, 0, +1}."""
        return _signs(self.pos, self.neg, self._dimension).to(torch.int8)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PackedTernary)
            and self._dimension == other._dimension
            and torch.equal(self.pos.cpu(), other.pos.cpu())
            and torch.equal(self.neg.cpu(), other.neg.cpu())
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"PackedTernary(dimension={self._dimension})"


def _signs(pos: torch.Tensor, neg: torch.Tensor, dimension: int) -> torch.Tensor:
    """(..., W) planes -> (..., dimension) int32 values in {-1, 0, +1}."""
    return unpack_bits(pos, dimension) - unpack_bits(neg, dimension)


def encode_ternary(values, threshold: float, device=None) -> PackedTernary:
    """Encode f32 values: ``> threshold`` -> +1, ``< -threshold`` -> -1,
    else 0 (reference ``src/ternary.rs:170``)."""
    values = as_tensor(values, torch.float32, device)
    pos, neg = encode_ternary_batch(values, threshold)
    return PackedTernary(pos, neg, int(values.shape[-1]))


def encode_ternary_values(values, device=None) -> PackedTernary:
    """Encode an integer {-1, 0, +1} array directly."""
    values = as_tensor(values, torch.int32, device)
    return PackedTernary(pack_bits(values > 0), pack_bits(values < 0), int(values.shape[-1]))


def encode_ternary_batch(rows, threshold: float, device=None):
    """Encode an (N, D) corpus -> ((N, W) pos, (N, W) neg) int32 planes."""
    rows = as_tensor(rows, torch.float32, device)
    t = f32_threshold(threshold)
    return pack_bits(rows > t), pack_bits(rows < -t)


def _check_dims(a: PackedTernary, b: PackedTernary, op: str) -> None:
    if a.dimension != b.dimension:
        raise ContractError(
            f"innr_tpu_torch::{op}: dimension mismatch ({a.dimension} vs {b.dimension})"
        )


def ternary_dot(a: PackedTernary, b: PackedTernary) -> torch.Tensor:
    """``popcount(same-sign) - popcount(opposite-sign)``, as int32
    (reference ``src/ternary.rs:198``)."""
    _check_dims(a, b, "ternary_dot")
    dev = a.pos.device
    return word_scores((a.pos, a.neg), (b.pos.to(dev), b.neg.to(dev))).sum(dtype=torch.int32)


def ternary_hamming(a: PackedTernary, b: PackedTernary) -> torch.Tensor:
    """Positions where both are non-zero and the signs differ, as int32
    (reference ``src/ternary.rs:308``)."""
    _check_dims(a, b, "ternary_hamming")
    dev = a.pos.device
    diff = (a.pos & b.neg.to(dev)) | (a.neg & b.pos.to(dev))
    return popcount32(diff).sum(dtype=torch.int32)


def asymmetric_dot(query, ternary: PackedTernary) -> torch.Tensor:
    """f32 query x ternary doc, a float32 scalar (reference
    ``src/ternary.rs:293``)."""
    query = as_tensor(query, torch.float32, ternary.pos.device)
    if query.shape[-1] != ternary.dimension:
        raise ContractError(
            f"innr_tpu_torch::asymmetric_dot: dimension mismatch "
            f"({query.shape[-1]} vs {ternary.dimension})"
        )
    return (query * _signs(ternary.pos, ternary.neg, ternary.dimension).float()).sum()


def sparsity(v: PackedTernary) -> float:
    """Fraction of zeros (reference ``src/ternary.rs:334``); zero dimension
    -> 0.0."""
    if v.dimension == 0:
        return 0.0
    return 1.0 - v.nnz() / v.dimension


def batch_ternary_dot(query: PackedTernary, pos_corpus, neg_corpus) -> torch.Tensor:
    """Ternary dots of one query against (N, W) corpus planes -> (N,)
    int32."""
    pos_c = as_words(pos_corpus)
    neg_c = as_words(neg_corpus, pos_c.device)
    return _hamming.batch_ternary_dot_words(
        query.pos.to(pos_c.device), query.neg.to(pos_c.device), pos_c, neg_c)


class PackedTernaryBatch:
    """An encoded ternary corpus: (N, W) int32 ``pos`` / ``neg`` planes plus
    their cached word-major transposes ``pos_t`` / ``neg_t`` (W, N), the
    layout the kNN kernel streams."""

    __slots__ = ("pos", "neg", "pos_t", "neg_t", "_dimension")

    def __init__(self, pos, neg, dimension: int, device=None):
        pos = as_words(pos, device)
        neg = as_words(neg, pos.device)
        if pos.dim() != 2 or pos.shape != neg.shape or pos.shape[1] != num_words(dimension):
            raise ContractError(
                f"PackedTernaryBatch: plane shapes {tuple(pos.shape)}/{tuple(neg.shape)} "
                f"don't match dimension {dimension}"
            )
        self.pos = mask_padding(pos, dimension).contiguous()
        self.neg = mask_padding(neg, dimension).contiguous()
        self.pos_t = self.pos.T.contiguous()
        self.neg_t = self.neg.T.contiguous()
        self._dimension = int(dimension)

    @classmethod
    def encode(cls, rows, threshold: float, device=None) -> "PackedTernaryBatch":
        rows = as_tensor(rows, torch.float32, device)
        pos, neg = encode_ternary_batch(rows, threshold)
        return cls(pos, neg, int(rows.shape[1]))

    @classmethod
    def from_numpy(cls, pos, neg, dimension: int, device=None) -> "PackedTernaryBatch":
        """From (N, W) uint32 planes, e.g. ``np.asarray`` of an ``innr_tpu``
        batch's ``pos`` and ``neg``."""
        return cls(np.asarray(pos, dtype=np.uint32), np.asarray(neg, dtype=np.uint32),
                   dimension, device)

    @property
    def num_vectors(self) -> int:
        return int(self.pos.shape[0])

    @property
    def dimension(self) -> int:
        return self._dimension

    def memory_bytes(self) -> int:
        return int(self.pos.numel() + self.neg.numel()) * 4


def _host_knn(dots, idx):
    return dots.cpu().numpy().astype(np.int32), idx.cpu().numpy().astype(np.int64)


def ternary_knn(query: PackedTernary, corpus: PackedTernaryBatch, k: int):
    """Top-k largest ternary dots over an encoded corpus — the symmetric
    coarse stage of the ternary pipeline. Returns numpy ``(dots descending,
    indices)``."""
    if query.dimension != corpus.dimension:
        raise ContractError(
            f"innr_tpu_torch::ternary_knn: dimension mismatch "
            f"({query.dimension} vs {corpus.dimension})"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int64)
    k = min(int(k), n)
    dev = corpus.pos_t.device
    return _host_knn(*_packed.fused_ternary_knn(
        query.pos.to(dev), query.neg.to(dev), corpus.pos_t, corpus.neg_t, k))


def _query_planes(queries, device):
    if isinstance(queries, PackedTernaryBatch):
        return queries.pos.to(device), queries.neg.to(device)
    if isinstance(queries, tuple) and len(queries) == 2 and not isinstance(
        queries[0], PackedTernary
    ):
        # Raw ((Q, W) pos, (Q, W) neg) planes, e.g. from encode_ternary_batch.
        return as_words(queries[0], device), as_words(queries[1], device)
    return (torch.stack([q.pos.to(device) for q in queries]),
            torch.stack([q.neg.to(device) for q in queries]))


def ternary_knn_batch(queries, corpus: PackedTernaryBatch, k: int):
    """Multi-query ternary kNN in one corpus read per pass. ``queries``: a
    list of :class:`PackedTernary`, a :class:`PackedTernaryBatch`, or a raw
    ``((Q, W) pos, (Q, W) neg)`` tuple. Returns numpy ``(dots (Q, k),
    indices (Q, k))``."""
    qp, qn = _query_planes(queries, corpus.pos.device)
    if qp.dim() != 2 or qp.shape[1] != corpus.pos.shape[1] or qn.shape != qp.shape:
        raise ContractError(
            f"innr_tpu_torch::ternary_knn_batch: query planes {tuple(qp.shape)} don't "
            f"match corpus word count {corpus.pos.shape[1]}"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        n_q = int(qp.shape[0])
        return np.zeros((n_q, 0), np.int32), np.zeros((n_q, 0), np.int64)
    k = min(int(k), n)
    return _host_knn(*_packed.fused_ternary_knn_batch(qp, qn, corpus.pos_t, corpus.neg_t, k))


def batch_asymmetric_dot(query, pos_corpus, neg_corpus, dimension: int) -> torch.Tensor:
    """f32 query x encoded ternary corpus -> (N,) float32 rerank scores: the
    planes unpacked to a {-1, 0, +1} matrix and one float32 matrix-vector
    product (TF32 only if ``config.set_matmul_precision("default")``)."""
    pos_c = as_words(pos_corpus)
    neg_c = as_words(neg_corpus, pos_c.device)
    query = as_tensor(query, torch.float32, pos_c.device)
    return _signs(pos_c, neg_c, dimension).float() @ query
