"""Dense f32 vector primitives: dot, cosine, norms, L1/L2, matryoshka.

The counterpart of :mod:`innr_tpu.ops.dense` (reference ``src/dense.rs``).
A single pair is a plain PyTorch reduction on the inputs' device; no kernel,
as the JAX package leaves these to XLA. The batch layer
(:mod:`innr_tpu_torch.batch`) is where they become matrix products and
kernels.

Contracts (reference ``src/lib.rs:34-46``):

- length mismatch raises :class:`~innr_tpu_torch.utils.asserts.ContractError`;
- zero norms: similarity ops return ``0.0`` when either norm is below
  ``1e-9`` (squared-space compare against ``NORM_EPSILON_SQ``);
- NaN propagates through ``dot`` and the distances; ``cosine`` returns
  ``0.0`` for NaN inputs (the zero-norm guard absorbs them);
- empty inputs: reductions return ``0.0``.

Results are 0-d float32 tensors. ``normalize`` returns a new tensor; the
original norm comes from :func:`normalize_with_norm`. Host data goes to the
default device (the card); the second argument follows the first's device.
"""

from __future__ import annotations

import math

import torch

from innr_tpu_torch.config import NORM_EPSILON, NORM_EPSILON_SQ
from innr_tpu_torch.utils.asserts import check_same_length
from innr_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "dot",
    "norm",
    "normalize",
    "normalize_with_norm",
    "cosine",
    "angular_distance",
    "l2_distance",
    "l2_distance_squared",
    "l1_distance",
    "matryoshka_dot",
    "matryoshka_cosine",
]


def _pair_f32(a, b, op: str | None = None):
    a = as_tensor(a, torch.float32)
    b = as_tensor(b, torch.float32, a.device)
    if op is not None:
        check_same_length(a, b, op)
    return a, b


def dot(a, b) -> torch.Tensor:
    """Dot product ``sum(a[i] * b[i])`` (reference ``src/dense.rs:56``);
    ``0.0`` for empty inputs; NaN propagates."""
    a, b = _pair_f32(a, b, "dot")
    return (a * b).sum()


def norm(v) -> torch.Tensor:
    """L2 norm ``sqrt(dot(v, v))`` (reference ``src/dense.rs:139``)."""
    v = as_tensor(v, torch.float32)
    return torch.sqrt((v * v).sum())


def normalize(v) -> torch.Tensor:
    """``v`` scaled to unit length (reference ``src/dense.rs:160``); a
    vector of norm below ``1e-9`` comes back unchanged."""
    return normalize_with_norm(v)[0]


def normalize_with_norm(v) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize and also return the original L2 norm
    (reference ``src/dense.rs:177``)."""
    v = as_tensor(v, torch.float32)
    n = torch.sqrt((v * v).sum())
    return torch.where(n > NORM_EPSILON, v / n, v), n


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ab, aa, bb = (a * b).sum(), (a * a).sum(), (b * b).sum()
    ok = (aa > NORM_EPSILON_SQ) & (bb > NORM_EPSILON_SQ)
    return torch.where(ok, ab / torch.where(ok, torch.sqrt(aa * bb), 1.0), 0.0)


def cosine(a, b) -> torch.Tensor:
    """Cosine similarity from ``dot(a, b)``, ``||a||^2`` and ``||b||^2``
    (reference ``src/dense.rs:243``). ``0.0`` when either squared norm is at
    or below ``NORM_EPSILON_SQ``; NaN norms fail the ``>`` test and give
    ``0.0``."""
    return _cosine(*_pair_f32(a, b, "cosine"))


def angular_distance(a, b) -> torch.Tensor:
    """Normalized angle ``acos(clamp(cosine)) / pi`` in ``[0, 1]``
    (reference ``src/dense.rs:376``)."""
    return torch.arccos(cosine(a, b).clamp(-1.0, 1.0)) / math.pi


def l2_distance_squared(a, b) -> torch.Tensor:
    """Squared Euclidean distance (reference ``src/dense.rs:596``)."""
    a, b = _pair_f32(a, b, "l2_distance_squared")
    d = a - b
    return (d * d).sum()


def l2_distance(a, b) -> torch.Tensor:
    """Euclidean distance (reference ``src/dense.rs:468``)."""
    return torch.sqrt(l2_distance_squared(a, b))


def l1_distance(a, b) -> torch.Tensor:
    """Manhattan distance (reference ``src/dense.rs:499``)."""
    a, b = _pair_f32(a, b, "l1_distance")
    return (a - b).abs().sum()


def _prefix(a, b, prefix_len: int):
    a, b = _pair_f32(a, b)
    end = min(int(prefix_len), a.shape[-1], b.shape[-1])
    return a[..., :end], b[..., :end]


def matryoshka_dot(a, b, prefix_len: int) -> torch.Tensor:
    """Dot product over the first ``prefix_len`` dims, clamped to the
    shorter input (reference ``src/dense.rs:427``)."""
    a, b = _prefix(a, b, prefix_len)
    return (a * b).sum()


def matryoshka_cosine(a, b, prefix_len: int) -> torch.Tensor:
    """Cosine over the first ``prefix_len`` dims
    (reference ``src/dense.rs:450``)."""
    return _cosine(*_prefix(a, b, prefix_len))
