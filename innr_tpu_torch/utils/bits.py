"""Packed-bit helpers for int32 words (popcount, pack, unpack) and the
signed views of unsigned values.

The JAX package keeps packed vectors as ``uint32`` words (bit ``i % 32`` of
word ``i // 32``). PyTorch's ``uint32`` has no ``>>`` and no ``topk`` on the
CPU, so this package holds the same words as bit-identical ``int32`` views:
bit 31 is the sign bit. ``>>`` on ``int32`` is arithmetic (it copies the
sign bit down), so a shift below either runs on a non-negative word or is
followed by a mask. MinHash slots (``uint16`` / ``uint32`` / ``uint64``)
and sparse indices (``uint32``) are held the same way, as ``int16`` /
``int32`` / ``int64`` views (:func:`as_unsigned`).

torch has no popcount op; :func:`popcount32` and :func:`popcount8` are SWAR
(SIMD-within-a-register) bit counts for the plain versions of the packed
kernels. The CUDA kernels use ``__popc``.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.utils.tensors import host_device

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
    """Packed words as an int32 tensor: :func:`as_unsigned` at 32 bits."""
    return as_unsigned(x, 32, device)


# uint16 / uint32 / uint64 values (slots, sparse indices) are held as
# bit-identical int16 / int32 / int64 views, as packed words are: a
# comparison for equality is unchanged; an ordering must not use the signed
# view (compare on the host, or mask to the low bits in a wider type).
_UNSIGNED_NP = {16: np.uint16, 32: np.uint32, 64: np.uint64}
_SIGNED_NP = {16: np.int16, 32: np.int32, 64: np.int64}
VIEW_DTYPES = {16: torch.int16, 32: torch.int32, 64: torch.int64}
_TORCH_UNSIGNED = {
    bits: getattr(torch, f"uint{bits}") for bits in (16, 32, 64) if hasattr(torch, f"uint{bits}")
}


def unsigned_bits(dtype) -> int | None:
    """The width of the unsigned values a dtype holds: a numpy unsigned
    type's own width; for torch, this package's views (int16 / int32 /
    int64) and torch's own uint16 / uint32 / uint64 by their width; None
    for anything else."""
    if isinstance(dtype, torch.dtype):
        for bits, view in VIEW_DTYPES.items():
            if dtype in (view, _TORCH_UNSIGNED.get(bits)):
                return bits
        return None
    try:
        dt = np.dtype(dtype)
    except TypeError:
        return None
    return dt.itemsize * 8 if dt.kind == "u" and dt.itemsize >= 2 else None


def as_unsigned(x, bits: int, device=None) -> torch.Tensor:
    """``uint{bits}`` values as an ``int{bits}`` tensor with the same bits.

    A tensor of the view type stays as it is, a torch unsigned tensor of the
    same width is viewed; another tensor keeps the low ``bits`` bits of its
    value, where a view or unsigned tensor of another width holds the
    unsigned value of its own width (an int16 view of 65535 widens to
    65535). Host data (numpy, sequences, JAX arrays) is cast to
    ``uint{bits}`` as numpy casts and goes to
    :func:`~innr_tpu_torch.utils.tensors.host_device`. Moved to ``device``
    when one is given. Callers that must not narrow check the input's width
    first."""
    view = VIEW_DTYPES[bits]
    if isinstance(x, torch.Tensor):
        if x.dtype == _TORCH_UNSIGNED.get(bits):
            x = x.view(view)
        elif x.dtype != view:
            src_bits = unsigned_bits(x.dtype)
            if x.dtype in _TORCH_UNSIGNED.values():
                x = x.view(VIEW_DTYPES[src_bits])
            x = x.to(torch.int64)
            if src_bits is not None and src_bits < 64:
                x = x & ((1 << src_bits) - 1)
            if bits < 64:
                x = x & ((1 << bits) - 1)
                x = torch.where(x >= 1 << (bits - 1), x - (1 << bits), x)
            x = x.to(view)
        return x if device is None else x.to(device)
    dev = host_device(device)
    a = np.ascontiguousarray(np.asarray(x).astype(_UNSIGNED_NP[bits]))
    return torch.from_numpy(a.view(_SIGNED_NP[bits]).copy()).to(dev)


def unsigned_to_numpy(t: torch.Tensor) -> np.ndarray:
    """An int16 / int32 / int64 view -> the uint16 / uint32 / uint64 numpy
    array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(_UNSIGNED_NP[t.element_size() * 8])


# Packed words are uint32 values: int32 word tensor -> uint32 numpy array.
words_to_numpy = unsigned_to_numpy
