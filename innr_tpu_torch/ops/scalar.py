"""Scalar (uint8) quantization with asymmetric f32-query scoring.

The counterpart of :mod:`innr_tpu.ops.scalar`. The scheme (reference
``src/scalar.rs:8-29``):

    u8    = clamp(round((f32 - offset) / alpha * 255), 0, 255)
    dot(q, dequant(d)) = (alpha/255) * sum(q[i] * d[i]) + offset * sum(q[i])

The kNN functions keep the codes as uint8 on the device (one byte per
dimension read) and run the fused kNN kernel's u8 mode on the raw mixed dot;
the affine correction is a per-query monotone map applied after selection.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from innr_tpu_torch.kernels import knn as _kernels
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "QuantizationParams",
    "QuantizedU8",
    "QuantizedU8Batch",
    "quantize_u8",
    "QueryContext",
    "query_context",
    "asymmetric_dot_u8",
    "asymmetric_dot_u8_precomputed",
    "mixed_dot_u8_f32",
    "batch_knn_u8",
    "batch_knn_u8_multi",
]


@dataclass(frozen=True)
class QuantizationParams:
    """Affine quantization parameters shared by a collection
    (reference ``src/scalar.rs:44``)."""

    alpha: float
    offset: float

    @classmethod
    def from_range(cls, min_val: float, max_val: float) -> "QuantizationParams":
        """From an explicit range; degenerate ranges get alpha=1."""
        alpha = float(max_val) - float(min_val)
        return cls(alpha=alpha if alpha > 0.0 else 1.0, offset=float(min_val))

    @classmethod
    def fit(cls, values) -> "QuantizationParams":
        """Min/max over a flat value slice (reference ``src/scalar.rs:68``).
        A tensor is reduced on its own device; NaN propagates, as numpy's
        min/max propagate it."""
        v = as_tensor(values, torch.float32).detach().reshape(-1)
        if v.numel() == 0:
            return cls(alpha=1.0, offset=0.0)
        return cls.from_range(float(v.min()), float(v.max()))

    @classmethod
    def fit_quantile(cls, values, quantile: float) -> "QuantizationParams":
        """Quantile-clipped range over *finite* values (reference
        ``src/scalar.rs:104``): ``quantile=0.99`` uses the 0.5th and 99.5th
        percentiles, clamping outliers to 0/255."""
        if not (0.0 < quantile <= 1.0):
            raise ContractError("quantile must be in (0.0, 1.0]")
        v = _host_f32(values).reshape(-1)
        if v.size == 0:
            return cls(alpha=1.0, offset=0.0)
        if quantile >= 1.0:
            return cls.fit(v)
        finite = np.sort(v[np.isfinite(v)])
        if finite.size == 0:
            return cls(alpha=1.0, offset=0.0)
        tail = (1.0 - quantile) / 2.0
        lo_idx = int(np.floor(tail * finite.size))
        hi_idx = min(int(np.ceil((1.0 - tail) * finite.size)), finite.size - 1)
        return cls.from_range(float(finite[lo_idx]), float(finite[hi_idx]))

    @classmethod
    def fit_vectors(cls, vectors) -> "QuantizationParams":
        """Global range over a corpus of vectors (reference ``src/scalar.rs:143``)."""
        mins, maxs = [], []
        for v in vectors:
            v = _host_f32(v)
            if v.size:
                mins.append(float(np.min(v)))
                maxs.append(float(np.max(v)))
        if not mins:
            return cls(alpha=1.0, offset=0.0)
        return cls.from_range(min(mins), max(maxs))


def _host_f32(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().float().cpu().numpy()
    return np.asarray(values, dtype=np.float32)


class QuantizedU8:
    """A single scalar-quantized vector (reference ``src/scalar.rs:171``)."""

    __slots__ = ("codes",)

    def __init__(self, data, dimension: int | None = None, device=None):
        codes = as_tensor(data, torch.uint8, device)
        if codes.dim() != 1:
            raise ContractError("QuantizedU8: data must be 1-D")
        if dimension is not None and codes.shape[0] != dimension:
            raise ContractError(
                f"QuantizedU8: data length {codes.shape[0]} doesn't match "
                f"dimension {dimension}"
            )
        self.codes = codes

    def data(self) -> torch.Tensor:
        return self.codes

    @property
    def dimension(self) -> int:
        return int(self.codes.shape[0])

    def memory_bytes(self) -> int:
        return int(self.codes.shape[0])


class QuantizedU8Batch:
    """An (N, D) corpus of uint8 codes, the container for the u8 kNN scans."""

    __slots__ = ("codes",)

    def __init__(self, codes, device=None):
        codes = as_tensor(codes, torch.uint8, device)
        if codes.dim() != 2:
            raise ContractError("QuantizedU8Batch: codes must be 2-D (N, D)")
        self.codes = codes.contiguous()

    @classmethod
    def from_numpy(cls, codes: np.ndarray, device=None) -> "QuantizedU8Batch":
        """From an (N, D) uint8 numpy array, e.g. an ``innr_tpu`` batch's codes."""
        return cls(np.asarray(codes, dtype=np.uint8), device=device)

    @classmethod
    def quantize(cls, rows, params: QuantizationParams, device=None) -> "QuantizedU8Batch":
        return cls(_quantize(as_tensor(rows, torch.float32, device), params.alpha, params.offset))

    @property
    def num_vectors(self) -> int:
        return int(self.codes.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.codes.shape[1])

    def memory_bytes(self) -> int:
        return int(self.codes.numel())


def _quantize(values: torch.Tensor, alpha: float, offset: float) -> torch.Tensor:
    # Both constants are rounded to f32 first, as the JAX package does.
    inv_alpha = float(np.float32(255.0 / alpha))
    normalized = (values - float(np.float32(offset))) * inv_alpha
    # Half-away-from-zero rounding (reference f32::round), not half-to-even:
    # floor(x + 0.5) agrees with it on the clamped [0, 255] range.
    return torch.clamp(torch.floor(normalized + 0.5), 0.0, 255.0).to(torch.uint8)


def quantize_u8(values, params: QuantizationParams, device=None) -> QuantizedU8:
    """Quantize one f32 vector (reference ``src/scalar.rs:212``)."""
    values = as_tensor(values, torch.float32, device)
    return QuantizedU8(_quantize(values, params.alpha, params.offset))


@dataclass(frozen=True)
class QueryContext:
    """Precomputed ``sum(q[i])`` (reference ``src/scalar.rs:229``)."""

    query_sum: float


def query_context(query) -> QueryContext:
    """Precompute the query sum once per query (reference ``src/scalar.rs:236``)."""
    return QueryContext(query_sum=float(as_tensor(query, torch.float32, None).sum()))


def mixed_dot_u8_f32(a, b) -> torch.Tensor:
    """Raw mixed-precision inner loop ``sum(a_f32[i] * b_u8[i])``
    (reference ``src/scalar.rs:314``)."""
    a = as_tensor(a, torch.float32, None)
    b = as_tensor(b, torch.uint8, a.device)
    if a.shape[-1] != b.shape[-1]:
        raise ContractError(
            f"mixed_dot_u8_f32: slice length mismatch ({a.shape[-1]} vs {b.shape[-1]})"
        )
    return (a * b.float()).sum()


def _affine(mixed, q_sum, params: QuantizationParams):
    return float(np.float32(params.alpha / 255.0)) * mixed + float(np.float32(params.offset)) * q_sum


def asymmetric_dot_u8(query, quantized: QuantizedU8, params: QuantizationParams) -> torch.Tensor:
    """f32 query x quantized doc without dequantizing (reference ``src/scalar.rs:261``)."""
    q = as_tensor(query, torch.float32, quantized.codes.device)
    if q.shape[-1] != quantized.dimension:
        raise ContractError(
            f"asymmetric_dot_u8: dimension mismatch ({q.shape[-1]} vs {quantized.dimension})"
        )
    return _affine((q * quantized.codes.float()).sum(), q.sum(), params)


def asymmetric_dot_u8_precomputed(
    query, quantized: QuantizedU8, params: QuantizationParams, ctx: QueryContext
) -> torch.Tensor:
    """Asymmetric dot with the query sum amortized across the corpus
    (reference ``src/scalar.rs:284``)."""
    q = as_tensor(query, torch.float32, quantized.codes.device)
    if q.shape[-1] != quantized.dimension:
        raise ContractError(
            f"asymmetric_dot_u8_precomputed: dimension mismatch "
            f"({q.shape[-1]} vs {quantized.dimension})"
        )
    mixed = (q * quantized.codes.float()).sum()
    return float(np.float32(params.alpha / 255.0)) * mixed + float(
        np.float32(params.offset * ctx.query_sum)
    )


def batch_knn_u8(query, corpus, params: QuantizationParams, k: int) -> list[tuple[int, float]]:
    """Quantized first-pass kNN (reference ``src/scalar.rs:370``).

    ``corpus``: a :class:`QuantizedU8Batch` or a sequence of
    :class:`QuantizedU8` (stacked once). Returns the top-k ``(index,
    score)`` pairs, highest similarity first."""
    if isinstance(corpus, QuantizedU8Batch):
        codes = corpus.codes
    else:
        corpus = list(corpus)
        if not corpus:
            return []
        codes = torch.stack([c.codes for c in corpus])
    if codes.shape[0] == 0 or k == 0:
        return []
    q = as_tensor(query, torch.float32, codes.device)
    if q.dim() != 1 or q.shape[0] != codes.shape[1]:
        raise ContractError(
            f"batch_knn_u8: dimension mismatch ({q.shape[-1]} vs {codes.shape[1]})"
        )
    k = min(int(k), int(codes.shape[0]))
    mixed, idx = _kernels.fused_knn_u8_batch(q[None, :].contiguous(), codes, k)
    vals = _affine(mixed[0], q.sum(), params)
    return [(int(i), float(v)) for i, v in zip(idx[0].cpu().numpy(), vals.cpu().numpy())]


def batch_knn_u8_multi(queries, corpus: QuantizedU8Batch, params: QuantizationParams, k: int):
    """(Q, D) f32 queries against a u8 corpus in one corpus read per pass.
    Returns ``(scores (Q, k) descending, indices (Q, k))`` tensors; scores
    carry the full affine correction."""
    qs = as_tensor(queries, torch.float32, corpus.codes.device)
    if qs.dim() != 2 or qs.shape[1] != corpus.dimension:
        raise ContractError(
            f"batch_knn_u8_multi: queries shape {tuple(qs.shape)} != (Q, {corpus.dimension})"
        )
    n = corpus.num_vectors
    if n == 0 or k == 0:
        n_q = int(qs.shape[0])
        dev = corpus.codes.device
        return (
            torch.zeros((n_q, 0), dtype=torch.float32, device=dev),
            torch.zeros((n_q, 0), dtype=torch.int32, device=dev),
        )
    k = min(int(k), n)
    mixed, idx = _kernels.fused_knn_u8_batch(qs.contiguous(), corpus.codes, k)
    return _affine(mixed, qs.sum(dim=1, keepdim=True), params), idx
