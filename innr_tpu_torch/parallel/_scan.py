"""Shared per-device scan body and key decoding for the distribution layer.

The counterpart of :mod:`innr_tpu.parallel._scan`. Every index that merges
candidates across scans (the segments of
:class:`~innr_tpu_torch.segmented.SegmentedCorpus`; the shards of the
sharded family, still to be ported) runs the same local step, K1's raw keys
with global row indices, and the same decode after the merge. On a CUDA
tensor the step is the kernel (:func:`innr_tpu_torch.kernels.knn.
fused_knn_keys_batch`), on a CPU tensor its plain version: there is no
counterpart of the JAX package's ``use_fused`` arm split. One invariant
stays, the one :func:`decode_keys` exists for: the kernel's L2 keys lack
the per-query ``||q||^2`` (a shift that cannot change a selection), so the
decode adds it back and clamps at zero.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import invert_total_key

_INT_MIN = torch.iinfo(torch.int32).min


def _global(keys, lidx, n_total: int, base: int):
    gidx = lidx + base
    return torch.where(gidx < n_total, keys, _INT_MIN), gidx


def local_scan_keys(qs, rows, aux, n_total: int, k: int, mode: str, base: int = 0):
    """One scan's local top-k: (Q, D) queries x (rows_local, D) corpus block
    -> ``(keys (Q, k), global_idx (Q, k))`` int32, the keys raw total-order
    values (larger is better for every mode; L2 keys bit-inverted and
    without ``||q||^2``).

    ``aux``: per-row squared norms ("l2"), guarded inverse norms ("cosine",
    with unit queries), or None ("dot"). ``base``: this block's global row
    offset. Rows at or beyond ``n_total`` (padding) are pinned to INT32_MIN."""
    keys, lidx = _knn.fused_knn_keys_batch(qs, rows, aux, k, mode)
    return _global(keys, lidx, n_total, base)


def resolve_predicate_mask(predicate, n: int, op: str):
    """Shared predicate resolution for every ``knn_filtered`` entry point:
    a host callable ``index -> bool`` or an (N,) boolean mask ->
    ``(bool numpy mask, num_passing)``. Raises ``ContractError`` on a shape
    mismatch."""
    if callable(predicate):
        mask = np.fromiter((bool(predicate(i)) for i in range(n)), dtype=bool, count=n)
    else:
        if isinstance(predicate, torch.Tensor):
            predicate = predicate.cpu().numpy()
        mask = np.asarray(predicate, dtype=bool)
        if mask.shape != (n,):
            raise ContractError(f"innr_tpu_torch::{op}: mask shape {mask.shape} != ({n},)")
    return mask, int(mask.sum())


def local_scan_keys_filtered(qs, rows, norms2, mask, n_total: int, k: int, base: int = 0):
    """Predicate-pushdown variant of :func:`local_scan_keys` (L2 only):
    ``mask`` is this block's (rows_local,) float32 0/1 predicate; rows that
    fail it key INT32_MIN and can never beat a passing row."""
    aux = torch.stack([norms2.to(torch.float32), mask.to(device=norms2.device,
                                                          dtype=torch.float32)])
    keys, lidx = _knn.fused_knn_keys_batch(qs, rows, aux, k, "l2m")
    return _global(keys, lidx, n_total, base)


def decode_keys(keys, mode: str, qs):
    """Raw merged keys -> float32 scores. L2 keys flip back to distances,
    get the per-query ``||q||^2`` the kernel leaves out and clamp at zero
    (NaN propagates)."""
    if mode in ("l2", "l2m"):
        keys = ~keys
    vals = invert_total_key(keys)
    if mode in ("l2", "l2m"):
        vals = _knn._clamp_l2(vals, qs)
    return vals
