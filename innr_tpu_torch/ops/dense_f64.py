"""float64 vector primitives.

The counterpart of :mod:`innr_tpu.ops.dense_f64` (reference
``src/dense_f64.rs``). A TPU has no float64 units, so the JAX package
carries each value as a double-f32 pair; the H100 and the CPU have native
float64, so this package computes in float64 directly and has no df64
arithmetic. ``impl`` stays for API parity: "auto", "native" and "df64" all
run native float64, and any other value raises ``ValueError``.

Contracts (reference ``src/dense_f64.rs``): comparison over the *minimum*
length, no length error; empty inputs return 0.0; the zero-norm guard uses
``f64::EPSILON`` (2.22e-16) in norm space. Results are Python floats.
Host data goes to the default device (the card).
"""

from __future__ import annotations

import math

import torch

from innr_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "dot_f64",
    "norm_f64",
    "normalize_f64",
    "cosine_f64",
    "l2_distance_squared_f64",
    "l2_distance_f64",
    "l1_distance_f64",
]

_F64_EPSILON = float(torch.finfo(torch.float64).eps)
_IMPLS = ("auto", "native", "df64")


def _f64(v, device=None) -> torch.Tensor:
    return as_tensor(v, torch.float64, device).reshape(-1)


def _min_len(a, b, impl: str):
    if impl not in _IMPLS:
        raise ValueError(f"unknown dense_f64 impl {impl!r}")
    a = _f64(a)
    b = _f64(b, a.device)
    n = min(a.numel(), b.numel())
    return a[:n], b[:n]


def dot_f64(a, b, impl: str = "auto") -> float:
    """f64 dot product (reference ``src/dense_f64.rs:31``). Min-length
    semantics; empty -> 0.0."""
    a, b = _min_len(a, b, impl)
    return float((a * b).sum())


def norm_f64(v, impl: str = "auto") -> float:
    """f64 L2 norm (reference ``src/dense_f64.rs:95``)."""
    return math.sqrt(dot_f64(v, v, impl=impl))


def normalize_f64(v, impl: str = "auto") -> tuple[torch.Tensor, float]:
    """Unit-normalized copy and the original norm
    (reference ``src/dense_f64.rs:103``; a new tensor, not in place).
    Norms at or below ``f64::EPSILON`` leave the vector unchanged."""
    v = _f64(v).clone()
    n = norm_f64(v, impl=impl)
    return (v / n if n > _F64_EPSILON else v), n


def cosine_f64(a, b, impl: str = "auto") -> float:
    """f64 cosine with the ``f64::EPSILON`` zero-norm guard
    (reference ``src/dense_f64.rs:132``)."""
    na = norm_f64(a, impl=impl)
    nb = norm_f64(b, impl=impl)
    if not (na > _F64_EPSILON and nb > _F64_EPSILON):
        return 0.0
    return dot_f64(a, b, impl=impl) / (na * nb)


def l2_distance_squared_f64(a, b, impl: str = "auto") -> float:
    """f64 squared Euclidean distance (reference ``src/dense_f64.rs:148``)."""
    a, b = _min_len(a, b, impl)
    d = a - b
    return float((d * d).sum())


def l2_distance_f64(a, b, impl: str = "auto") -> float:
    """f64 Euclidean distance (reference ``src/dense_f64.rs:218``)."""
    return math.sqrt(l2_distance_squared_f64(a, b, impl=impl))


def l1_distance_f64(a, b, impl: str = "auto") -> float:
    """f64 Manhattan distance (reference ``src/dense_f64.rs:228``)."""
    a, b = _min_len(a, b, impl)
    return float((a - b).abs().sum())
