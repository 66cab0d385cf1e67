"""Fast approximate math: the bit-hack rsqrt and a fused approximate cosine.

The counterpart of :mod:`innr_tpu.ops.fast_math` (reference
``src/fast_math.rs``). The classic Quake-III inverse square root (magic
``0x5f375a86``, reference ``src/fast_math.rs:48-76``) is computed on the
float32 bits exactly as the JAX package computes it, so both give the same
bits; its accuracy contract (~0.5% relative error after one Newton-Raphson
step) holds. ``fast_cosine`` keeps the reference's one-pass structure and
zero-norm guard with ``torch.rsqrt``. Plain PyTorch on the inputs' device.
"""

from __future__ import annotations

import torch

from innr_tpu_torch.config import NORM_EPSILON_SQ
from innr_tpu_torch.utils.asserts import check_same_length
from innr_tpu_torch.utils.tensors import as_tensor

__all__ = [
    "fast_rsqrt",
    "fast_rsqrt_precise",
    "fast_cosine",
    "fast_cosine_dispatch",
]

_MAGIC = 0x5F375A86


def _rsqrt_bithack(x, nr_iterations: int) -> torch.Tensor:
    x = as_tensor(x, torch.float32)
    i = x.contiguous().view(torch.int32)
    y = (_MAGIC - (i >> 1)).view(torch.float32)
    for _ in range(nr_iterations):
        y = y * (1.5 - 0.5 * x * y * y)
    # Zero or negative inputs return 0.0 (reference src/fast_math.rs:50-52).
    return torch.where(x > 0.0, y, 0.0)


def fast_rsqrt(x) -> torch.Tensor:
    """Quake-III inverse square root, one NR iteration (~0.5% rel error).
    Reference ``src/fast_math.rs:48``. Elementwise."""
    return _rsqrt_bithack(x, nr_iterations=1)


def fast_rsqrt_precise(x) -> torch.Tensor:
    """Bit-hack rsqrt with two NR iterations (~full f32 precision).
    Reference ``src/fast_math.rs:65``."""
    return _rsqrt_bithack(x, nr_iterations=2)


def fast_cosine(a, b) -> torch.Tensor:
    """Fused approximate cosine (reference ``src/fast_math.rs:97``):
    ``ab * rsqrt(aa) * rsqrt(bb)``, ``0.0`` when either squared norm is at
    or below the epsilon. Raises on length mismatch regardless of size
    (reference ``src/fast_math.rs:497-503``)."""
    a = as_tensor(a, torch.float32)
    b = as_tensor(b, torch.float32, a.device)
    check_same_length(a, b, "fast_cosine")
    ab, aa, bb = (a * b).sum(), (a * a).sum(), (b * b).sum()
    ok = (aa > NORM_EPSILON_SQ) & (bb > NORM_EPSILON_SQ)
    safe_aa = torch.where(ok, aa, 1.0)
    safe_bb = torch.where(ok, bb, 1.0)
    return torch.where(ok, ab * torch.rsqrt(safe_aa) * torch.rsqrt(safe_bb), 0.0)


def fast_cosine_dispatch(a, b) -> torch.Tensor:
    """Alias of :func:`fast_cosine` for API parity
    (reference ``src/fast_math.rs:494``): there is one path."""
    return fast_cosine(a, b)
