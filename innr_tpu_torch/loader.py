"""Host-side corpus ingest (the data-loader layer).

The counterpart of :mod:`innr_tpu.loader`. A corpus to upload usually
starts as float32 rows on the host; packing it there sends the card 1/32
of the bytes (binary) or 1/4 (u8). These encoders run on the host CPU,
through the native C runtime (:mod:`innr_tpu_torch._native`, over
``native/innr_host.c``) when it builds and numpy otherwise, and give the
bits of the port's on-device encoders (``encode_binary_batch``,
``encode_ternary_batch``, ``QuantizedU8Batch.quantize``). The three corpus
encoders return the port's containers on ``device`` (default
:func:`innr_tpu_torch.config.default_device`, the card);
:func:`minhash_sketch_host` returns the uint32 sketches, as the JAX
package does, ready for :class:`~innr_tpu_torch.ops.slot.SketchCorpus`.
"""

from __future__ import annotations

import numpy as np

from innr_tpu_torch import _native
from innr_tpu_torch.ops.binary import PackedBinaryBatch
from innr_tpu_torch.ops.scalar import QuantizationParams, QuantizedU8Batch
from innr_tpu_torch.ops.ternary import PackedTernaryBatch

__all__ = [
    "encode_binary_host",
    "encode_ternary_host",
    "minhash_sketch_host",
    "quantize_u8_host",
]


def _pack_rows_numpy(bits: np.ndarray) -> np.ndarray:
    """(R, D) bool -> (R, ceil(D/32)) uint32, bit i % 32 of word i // 32."""
    r, d = bits.shape
    w = (d + 31) // 32
    packed = np.packbits(bits, axis=1, bitorder="little")
    full = np.zeros((r, w * 4), dtype=np.uint8)
    full[:, : packed.shape[1]] = packed
    return full.view(np.uint32)


def encode_binary_host(rows, threshold: float = 0.0, device=None) -> PackedBinaryBatch:
    """Encode an (R, D) float32 corpus to packed binary on the host CPU."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    words = _native.pack_binary_rows(rows, float(threshold))
    if words is None:
        words = _pack_rows_numpy(rows > np.float32(threshold))
    return PackedBinaryBatch.from_numpy(words, int(rows.shape[1]), device=device)


def encode_ternary_host(rows, threshold: float, device=None) -> PackedTernaryBatch:
    """Encode an (R, D) float32 corpus to ternary bitplanes on the host CPU."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    planes = _native.pack_ternary_rows(rows, float(threshold))
    if planes is None:
        t = np.float32(threshold)
        planes = _pack_rows_numpy(rows > t), _pack_rows_numpy(rows < -t)
    return PackedTernaryBatch.from_numpy(*planes, int(rows.shape[1]), device=device)


def quantize_u8_host(rows, params: QuantizationParams, device=None) -> QuantizedU8Batch:
    """Quantize an (R, D) float32 corpus to u8 codes on the host CPU.

    The codes are the on-device encoder's: ``255 / alpha`` taken in double
    and rounded to float32, the offset rounded to float32, half away from
    zero. The C encoder computes ``255 / alpha`` in float32 from a float32
    ``alpha``, which is the same number exactly when ``alpha`` is a float32
    value (a fitted ``alpha``, a difference of two float32 values, often is
    not); it runs only then."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    alpha = float(params.alpha)
    codes = None
    if float(np.float32(alpha)) == alpha:
        codes = _native.quantize_u8_rows(rows, alpha, float(params.offset))
    if codes is None:
        inv = np.float32(255.0 / alpha)
        normalized = (rows - np.float32(params.offset)) * inv
        codes = np.clip(np.floor(normalized + np.float32(0.5)), 0, 255).astype(np.uint8)
    return QuantizedU8Batch.from_numpy(codes, device=device)


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """numpy mirror of the C runtime's splitmix64 (the same bits)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def minhash_sketch_host(docs, n_slots: int) -> np.ndarray:
    """MinHash-sketch a collection of item sets on the host CPU.

    ``docs``: 1-D uint64 item arrays (shingle hashes; an empty document
    gives an all-0xFFFFFFFF row). Returns ``(n_docs, n_slots)`` uint32
    sketches: slot s of a document is the minimum over its items x of the
    high 32 bits of ``splitmix64(x + (s + 1) * 0x9E3779B97F4A7C15)``. The C
    path runs threads over documents (the same bits at any count)."""
    arrs = [np.ascontiguousarray(d, dtype=np.uint64).ravel() for d in docs]
    offsets = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum([a.size for a in arrs], out=offsets[1:])
    items = np.concatenate(arrs) if arrs else np.zeros(0, np.uint64)
    out = _native.minhash_rows(items, offsets, int(n_slots))
    if out is not None:
        return out
    out = np.full((len(arrs), int(n_slots)), 0xFFFFFFFF, np.uint32)
    seeds = np.uint64(0x9E3779B97F4A7C15) * np.arange(1, int(n_slots) + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for d, a in enumerate(arrs):
            if a.size:
                h = _splitmix64_np(a[:, None] + seeds[None, :])
                out[d] = (h >> np.uint64(32)).min(axis=0).astype(np.uint32)
    return out
