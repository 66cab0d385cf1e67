"""Integer primitives: u8 dot product and byte-packed bit Hamming.

The counterpart of :mod:`innr_tpu.ops.quant` (reference ``src/quant.rs``).
The JAX package computes these outside Pallas, and so does this package:
plain PyTorch on any device, with exact results. torch has no int32 matmul
on CUDA, and float32 loses integers above 2**24, so the u8 dots are float64
products: each term is at most 255**2 and a sum of D of them stays below
2**53 (exact) for any D that fits a device.

Return types: the JAX package returns ``uint32``; this package returns
int64 dots (a u8 dot reaches 255**2 * D, past int32 for D > 33025) and
int32 Hamming counts.

Contracts: dispatching functions raise :class:`ContractError` on length
mismatch; empty inputs return 0.
"""

from __future__ import annotations

import torch

from innr_tpu_torch.utils.asserts import check_same_length
from innr_tpu_torch.utils.bits import popcount8
from innr_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "dot_u8",
    "hamming_distance",
    "batch_hamming",
    "batch_dot_u8",
    "batch_dot_u8_s8",
]


def dot_u8(a, b) -> torch.Tensor:
    """u8 dot product (reference ``src/quant.rs:55``), as an int64 scalar."""
    a = as_tensor(a, torch.uint8)
    b = as_tensor(b, torch.uint8, a.device)
    check_same_length(a, b, "dot_u8")
    return (a.to(torch.int64) * b.to(torch.int64)).sum()


def hamming_distance(a, b) -> torch.Tensor:
    """Bit Hamming over byte-packed vectors (reference ``src/quant.rs:159``),
    as an int32 scalar."""
    a = as_tensor(a, torch.uint8)
    b = as_tensor(b, torch.uint8, a.device)
    check_same_length(a, b, "hamming_distance")
    return popcount8(a ^ b).sum(dtype=torch.int32)


def batch_hamming(query, corpus) -> torch.Tensor:
    """Bit Hamming of one byte-packed (W,) query against an (N, W) corpus ->
    (N,) int32."""
    corpus = as_tensor(corpus, torch.uint8)
    query = as_tensor(query, torch.uint8, corpus.device)
    check_same_length(query, corpus, "batch_hamming")
    return popcount8(corpus ^ query[None, :]).sum(dim=1, dtype=torch.int32)


def _dot_u8_rows(query, corpus, op: str) -> torch.Tensor:
    corpus = as_tensor(corpus, torch.uint8)
    query = as_tensor(query, torch.uint8, corpus.device)
    check_same_length(query, corpus, op)
    return (corpus.to(torch.float64) @ query.to(torch.float64)).to(torch.int64)


def batch_dot_u8(query, corpus) -> torch.Tensor:
    """u8 dot of one (D,) query against an (N, D) corpus -> (N,) int64."""
    return _dot_u8_rows(query, corpus, "batch_dot_u8")


def batch_dot_u8_s8(query, corpus) -> torch.Tensor:
    """The same exact u8 dots as :func:`batch_dot_u8`. The JAX package
    computes them through a zero-point-shifted int8 product for the TPU's
    int8 matrix unit; the result is identical, so this package has one
    product for both names."""
    return _dot_u8_rows(query, corpus, "batch_dot_u8_s8")
