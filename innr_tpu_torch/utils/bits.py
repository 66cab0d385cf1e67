"""Packed-bit helpers for int32 words: popcount, pack, unpack.

The JAX package keeps packed vectors as ``uint32`` words (bit ``i % 32`` of
word ``i // 32``). PyTorch's ``uint32`` has no ``>>`` and no ``topk`` on the
CPU, so this package holds the same words as bit-identical ``int32`` views:
bit 31 is the sign bit. ``>>`` on ``int32`` is arithmetic (it copies the
sign bit down), so a shift below either runs on a non-negative word or is
followed by a mask.

torch has no popcount op; :func:`popcount32` and :func:`popcount8` are SWAR
(SIMD-within-a-register) bit counts for the plain versions of the packed
kernels. The CUDA kernels use ``__popc``.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32

def num_words(dimension: int) -> int:
    """Words holding ``dimension`` bits."""
    return -(-dimension // WORD_BITS)


def bit_value(bit: int) -> int:
    """The int32 value of a word with only ``bit`` set (bit 31 is the sign)."""
    return 1 << bit if bit < 31 else -(1 << 31)


# Bit weights of one int32 word. Packing sums distinct weights, so every
# partial sum lies in int32's range.
_WEIGHTS = [bit_value(i) for i in range(WORD_BITS)]


def f32_threshold(threshold: float) -> float:
    """An encoding threshold rounded to float32, as the JAX package compares
    float32 values with it."""
    return float(np.float32(threshold))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (0..32), as int32.

    The sign bit is counted apart, so the SWAR steps run on a non-negative
    word and no intermediate overflows int32."""
    sign = (x < 0).to(torch.int32)
    x = x & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + sign


def popcount8(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint8 byte (0..8), as uint8."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., D) boolean tensor into (..., ceil(D / 32)) int32 words."""
    d = bits.shape[-1]
    w = num_words(d)
    pad = w * WORD_BITS - d
    if pad:
        zeros = torch.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype, device=bits.device)
        bits = torch.cat([bits, zeros], dim=-1)
    grouped = bits.reshape(bits.shape[:-1] + (w, WORD_BITS)).to(torch.int32)
    weights = torch.tensor(_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (grouped * weights).sum(dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, dimension: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., dimension) {0, 1} int32."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(bits.shape[:-2] + (-1,))[..., :dimension]


def mask_padding(words: torch.Tensor, dimension: int) -> torch.Tensor:
    """A copy of ``words`` with the bits past ``dimension`` cleared: distance
    ops popcount whole words."""
    rem = dimension % WORD_BITS
    if rem == 0:
        return words
    words = words.clone()
    words[..., -1] &= (1 << rem) - 1
    return words


def word_scores(queries, planes) -> torch.Tensor:
    """Per-word scores of query planes against corpus planes (broadcast),
    as int32. One plane each (binary): the Hamming count ``popc(p ^ a)``.
    Two (ternary; corpus ``(p, n)``, query ``(a, b)``): same-sign minus
    opposite-sign positions. The CUDA kernels' ``word_score``
    (``csrc/packed.cuh``)."""
    if len(planes) == 1:
        return popcount32(planes[0] ^ queries[0])
    (p, n), (a, b) = planes, queries
    return popcount32((p & a) | (n & b)) - popcount32((p & b) | (n & a))


def words_from_numpy(arr) -> torch.Tensor:
    """uint32 words (numpy or a sequence, e.g. a JAX array) as an int32
    tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy())


def as_words(x, device=None) -> torch.Tensor:
    """Packed words as an int32 tensor: an int32 tensor as it is, another
    integer tensor by its low 32 bits, anything else through
    :func:`words_from_numpy`. Moved to ``device`` when one is given (host
    data defaults to the CPU)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            x = x.to(torch.int64) & 0xFFFFFFFF
            x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
        return x if device is None else x.to(device)
    return words_from_numpy(x).to(device or "cpu")


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy array with the same bits."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)
