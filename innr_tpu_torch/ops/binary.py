"""Binary (1-bit) quantization: encode, Hamming, dot, Jaccard, kNN.

The counterpart of :mod:`innr_tpu.ops.binary` (reference
``src/binary.rs``). A vector is packed into 32-bit words, bit ``i % 32`` of
word ``i // 32``; the JAX package's ``uint32`` words are held here as
bit-identical int32 (:mod:`innr_tpu_torch.utils.bits`). ``from_numpy`` takes
the JAX containers' ``uint32`` arrays; ``data_u64`` / ``from_u64`` keep the
reference's u64 serialization.

The scans run on hand-written CUDA kernels for a corpus on a CUDA device
and on their plain versions for a corpus on the CPU:
``binary_knn`` / ``binary_knn_batch`` on ``packed_scan``
(:mod:`innr_tpu_torch.kernels.packed_knn`), ``batch_binary_hamming`` on
``packed_rows`` (:mod:`innr_tpu_torch.kernels.hamming`). Any k runs in the
kernel (exclusion-bounded passes); the results equal the JAX package's.

Return types: scalar and per-row ops return int32 tensors (the JAX package
returns uint32; the values are equal); ``binary_knn`` and
``binary_knn_batch`` return numpy ``(uint32 counts, int64 indices)`` as
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
    words_to_numpy,
)
from innr_tpu_torch.utils.tensors import as_tensor, host_device

__all__ = [
    "PackedBinary",
    "PackedBinaryBatch",
    "encode_binary",
    "encode_binary_batch",
    "binary_hamming",
    "binary_dot",
    "binary_jaccard",
    "batch_binary_hamming",
    "binary_knn",
    "binary_knn_batch",
]


class PackedBinary:
    """A packed binary vector: (W,) int32 words (reference
    ``src/binary.rs:37``). Padding bits past ``dimension`` are cleared."""

    __slots__ = ("words", "_dimension")

    def __init__(self, words, dimension: int, device=None):
        words = as_words(words, device)
        if tuple(words.shape) != (num_words(dimension),):
            raise ContractError(
                f"PackedBinary: data length {tuple(words.shape)} doesn't match "
                f"dimension {dimension} (expected {num_words(dimension)} words)"
            )
        self.words = mask_padding(words, dimension)
        self._dimension = int(dimension)

    # Reference constructor name.
    new = __init__

    @property
    def dimension(self) -> int:
        return self._dimension

    @classmethod
    def zeros(cls, dimension: int, device=None) -> "PackedBinary":
        z = torch.zeros(num_words(dimension), dtype=torch.int32, device=host_device(device))
        return cls(z, dimension)

    @classmethod
    def from_numpy(cls, words, dimension: int, device=None) -> "PackedBinary":
        """From (W,) uint32 words, e.g. ``np.asarray`` of an ``innr_tpu``
        vector's ``words``."""
        return cls(np.asarray(words, dtype=np.uint32), dimension, device)

    def data(self) -> torch.Tensor:
        """The packed int32 words."""
        return self.words

    def data_u64(self) -> np.ndarray:
        """Words re-packed as u64 little-endian — the reference's
        serialization layout (``src/binary.rs:71``)."""
        w = words_to_numpy(self.words)
        padded = np.zeros((-(-w.size // 2) * 2,), dtype=np.uint32)
        padded[: w.size] = w
        return padded.view(np.uint64)

    @classmethod
    def from_u64(cls, data, dimension: int, device=None) -> "PackedBinary":
        """Build from the reference's u64-word layout."""
        w = np.asarray(data, dtype=np.uint64).view(np.uint32)
        return cls(w[: num_words(dimension)], dimension, device)

    def set(self, idx: int, val: bool) -> "PackedBinary":
        """A copy with bit ``idx`` set to ``val``; out-of-range indices are
        ignored, as in the reference."""
        if not 0 <= idx < self._dimension:
            return self
        word, bit = divmod(idx, 32)
        w = self.words.clone()
        if val:
            w[word] |= bit_value(bit)
        else:
            w[word] &= ~bit_value(bit)
        return PackedBinary(w, self._dimension)

    def get(self, idx: int) -> bool:
        if not 0 <= idx < self._dimension:
            return False
        word, bit = divmod(idx, 32)
        return bool((int(self.words[word]) >> bit) & 1)

    def count_ones(self) -> int:
        return int(popcount32(self.words).sum())

    def memory_bytes(self) -> int:
        """Backing storage size (4 bytes per word)."""
        return int(self.words.shape[0]) * 4

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PackedBinary)
            and self._dimension == other._dimension
            and torch.equal(self.words.cpu(), other.words.cpu())
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"PackedBinary(dimension={self._dimension})"


def encode_binary(values, threshold: float = 0.0, device=None) -> PackedBinary:
    """Encode f32 values: strictly ``> threshold`` -> 1, NaN -> 0
    (reference ``src/binary.rs:133``)."""
    values = as_tensor(values, torch.float32, device)
    return PackedBinary(pack_bits(values > f32_threshold(threshold)), int(values.shape[-1]))


def encode_binary_batch(rows, threshold: float = 0.0, device=None) -> torch.Tensor:
    """Encode an (N, D) corpus into (N, ceil(D/32)) int32 words."""
    return pack_bits(as_tensor(rows, torch.float32, device) > f32_threshold(threshold))


def _check_dims(a: PackedBinary, b: PackedBinary, op: str) -> None:
    if a.dimension != b.dimension:
        raise ContractError(
            f"innr_tpu_torch::{op}: dimension mismatch ({a.dimension} vs {b.dimension})"
        )


def _count(words: torch.Tensor) -> torch.Tensor:
    return popcount32(words).sum(dtype=torch.int32)


def binary_hamming(a: PackedBinary, b: PackedBinary) -> torch.Tensor:
    """Differing-bit count: XOR + popcount (reference ``src/binary.rs:154``)."""
    _check_dims(a, b, "binary_hamming")
    return _count(a.words ^ b.words.to(a.words.device))


def binary_dot(a: PackedBinary, b: PackedBinary) -> torch.Tensor:
    """Intersection count: AND + popcount (reference ``src/binary.rs:178``)."""
    _check_dims(a, b, "binary_dot")
    return _count(a.words & b.words.to(a.words.device))


def binary_jaccard(a: PackedBinary, b: PackedBinary) -> torch.Tensor:
    """|A n B| / |A u B| as float32; empty union -> 1.0
    (reference ``src/binary.rs:199``)."""
    _check_dims(a, b, "binary_jaccard")
    bw = b.words.to(a.words.device)
    inter = _count(a.words & bw)
    union = _count(a.words | bw)
    ratio = inter.to(torch.float32) / union.to(torch.float32).clamp_min(1.0)
    return torch.where(union == 0, 1.0, ratio)


class PackedBinaryBatch:
    """A packed binary corpus: (N, W) int32 words plus the cached word-major
    transpose ``words_t`` (W, N), the layout the kNN kernel streams.
    ``memory_bytes`` counts ``words`` only, as the JAX package does."""

    __slots__ = ("words", "words_t", "_dimension")

    def __init__(self, words, dimension: int, device=None):
        words = as_words(words, device)
        if words.dim() != 2 or words.shape[1] != num_words(dimension):
            raise ContractError(
                f"PackedBinaryBatch: words shape {tuple(words.shape)} doesn't match "
                f"dimension {dimension}"
            )
        self.words = mask_padding(words, dimension).contiguous()
        self.words_t = self.words.T.contiguous()
        self._dimension = int(dimension)

    @classmethod
    def encode(cls, rows, threshold: float = 0.0, device=None) -> "PackedBinaryBatch":
        rows = as_tensor(rows, torch.float32, device)
        return cls(encode_binary_batch(rows, threshold), int(rows.shape[1]))

    @classmethod
    def from_numpy(cls, words, dimension: int, device=None) -> "PackedBinaryBatch":
        """From (N, W) uint32 words, e.g. ``np.asarray`` of an ``innr_tpu``
        batch's ``words``."""
        return cls(np.asarray(words, dtype=np.uint32), dimension, device)

    @property
    def num_vectors(self) -> int:
        return int(self.words.shape[0])

    @property
    def dimension(self) -> int:
        return self._dimension

    def memory_bytes(self) -> int:
        return int(self.words.numel()) * 4


def _host_knn(counts, idx):
    return counts.cpu().numpy().astype(np.uint32), idx.cpu().numpy().astype(np.int64)


def binary_knn(query: PackedBinary, corpus: PackedBinaryBatch, k: int):
    """Top-k nearest by bit-Hamming over a packed corpus — the coarse stage
    of the binary retrieval pipeline. Returns numpy ``(counts ascending,
    indices)``."""
    if query.dimension != corpus.dimension:
        raise ContractError(
            f"innr_tpu_torch::binary_knn: dimension mismatch "
            f"({query.dimension} vs {corpus.dimension})"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        return np.zeros((0,), np.uint32), np.zeros((0,), np.int64)
    k = min(int(k), n)
    q = query.words.to(corpus.words_t.device)
    return _host_knn(*_packed.fused_binary_knn(q, corpus.words_t, k))


def _query_words(queries, device) -> torch.Tensor:
    if isinstance(queries, PackedBinaryBatch):
        return queries.words.to(device)
    if isinstance(queries, (list, tuple)):
        return torch.stack([q.words.to(device) for q in queries])
    return as_words(queries, device)


def binary_knn_batch(queries, corpus: PackedBinaryBatch, k: int):
    """Multi-query binary kNN in one corpus read per pass. ``queries``:
    (Q, W) words, a list of :class:`PackedBinary` or a
    :class:`PackedBinaryBatch`. Returns numpy ``(counts (Q, k), indices
    (Q, k))``."""
    q_words = _query_words(queries, corpus.words.device)
    if q_words.dim() != 2 or q_words.shape[1] != corpus.words.shape[1]:
        raise ContractError(
            f"innr_tpu_torch::binary_knn_batch: query words {tuple(q_words.shape)} "
            f"don't match corpus word count {corpus.words.shape[1]}"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        n_q = int(q_words.shape[0])
        return np.zeros((n_q, 0), np.uint32), np.zeros((n_q, 0), np.int64)
    k = min(int(k), n)
    return _host_knn(*_packed.fused_binary_knn_batch(q_words, corpus.words_t, k))


def batch_binary_hamming(query, corpus) -> torch.Tensor:
    """Hamming of one packed query ((W,) words or :class:`PackedBinary`)
    against an (N, W) packed corpus -> (N,) int32."""
    corpus = as_words(corpus)
    if isinstance(query, PackedBinary):
        query = query.words
    query = as_words(query, corpus.device)
    if corpus.shape[-1] != query.shape[-1]:
        raise ContractError(
            f"innr_tpu_torch::batch_binary_hamming: word-count mismatch "
            f"({corpus.shape[-1]} vs {query.shape[-1]})"
        )
    return _hamming.batch_hamming_words(query, corpus)
