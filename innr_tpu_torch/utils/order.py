"""IEEE-754 total ordering for f32 scores, with lowest-index ties.

The counterpart of :mod:`innr_tpu.utils.order`. A float is reinterpreted as
int32 and negative values are XORed with ``0x7FFFFFFF``; ascending int32
keys then follow ``f32::total_cmp``: -NaN < -inf < ... < -0.0 < +0.0 < ...
< +inf < +NaN.

``torch.topk`` promises no order among equal values, so selection runs on
one int64 *composite* key per candidate, ``key << 32 | (0xFFFFFFFF - idx)``:
a larger composite means a larger key, or an equal key at a lower index.
Composites of distinct indices never tie, so one top-k over them gives
"key descending, index ascending" exactly, with no stable sort. The CUDA
kernel (``csrc/knn.cu``) builds the same composite, and :func:`merge_parts`,
the one merge of candidate lists across scans, ranks on it.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def total_order_key_f32(x: torch.Tensor) -> torch.Tensor:
    """Map f32 values to int32 keys whose ``<`` equals ``f32::total_cmp``."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    mask = torch.where(bits < 0, 0x7FFFFFFF, 0).to(torch.int32)
    return bits ^ mask


def canonical_nan(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every NaN made the quiet NaN 0x7FC00000, the NaN a CUDA
    kernel returns (CPUs propagate payloads and signs), so that NaN scores
    key alike on every device."""
    nan = torch.tensor(0x7FC00000, dtype=torch.int32, device=x.device).view(torch.float32)
    return torch.where(torch.isnan(x), nan, x)


def invert_total_key(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`total_order_key_f32` (the map is an involution)."""
    mask = torch.where(keys < 0, 0x7FFFFFFF, 0).to(torch.int32)
    return (keys ^ mask).contiguous().view(torch.float32)


def composite_keys(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 composites of int32 ``keys`` and non-negative ``idx`` (broadcast)."""
    return (keys.to(torch.int64) << 32) | (_LOW32 - idx.to(torch.int64))


def split_composite(comp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(keys, idx)`` as int32 from composites. ``torch.iinfo(int64).min``,
    the empty slot, decodes to ``(INT32_MIN, -1)``."""
    keys = (comp >> 32).to(torch.int32)
    idx = (_LOW32 - (comp & _LOW32)).to(torch.int32)
    return keys, idx


def merge_parts(parts, k: int, dev):
    """The one merge of candidate lists: ``parts`` is a list of ``(keys,
    idx)`` int32 pairs (Q, k_i), larger keys better (K1's raw keys; each
    part may sit on its own device), holding k candidates in all or more.
    Returns the k best as int32 ``(keys, idx)`` (Q, k) on ``dev``: key
    descending, then the lowest index, by one ``torch.topk`` over int64
    composites. A single part that already holds k candidates is returned
    as it is (every scan returns its candidates in this order). An empty
    slot, ``(INT32_MIN, -1)`` as :func:`split_composite` decodes it, loses
    to every key above INT32_MIN."""
    if len(parts) == 1 and parts[0][0].shape[1] == k:
        return tuple(_on(t, dev) for t in parts[0])
    keys = torch.cat([_on(p[0], dev) for p in parts], dim=1)
    idx = torch.cat([_on(p[1], dev) for p in parts], dim=1)
    pos = torch.topk(composite_keys(keys, idx), k, dim=1).indices
    return torch.gather(keys, 1, pos), torch.gather(idx, 1, pos)


def _on(t: torch.Tensor, dev) -> torch.Tensor:
    """``t`` on ``dev``, without a call where it is there already: even a
    copy that does nothing releases the interpreter lock, and a serving
    thread then waits for it behind the other threads."""
    return t if t.device == dev else t.to(dev, non_blocking=True)


def argsort_total(x: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Stable argsort of f32 values under IEEE total ordering."""
    keys = total_order_key_f32(x)
    if descending:
        keys = ~keys
    return torch.argsort(keys, dim=-1, stable=True)


def top_k_total(
    x: torch.Tensor, k: int, largest: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of f32 values under total ordering along the last axis.

    Returns ``(values, indices)`` best-first; ties resolve to the lower
    index; NaN sorts greatest (first when ``largest``, last otherwise).
    """
    keys = total_order_key_f32(x)
    if not largest:
        keys = ~keys
    idx = torch.arange(x.shape[-1], device=x.device)
    _, pos = torch.topk(composite_keys(keys, idx), k, dim=-1)
    return torch.gather(x, -1, pos), pos
