"""The per-device scan body of the distribution layer.

The counterpart of :mod:`innr_tpu.parallel._scan`, less its decode. Every
container of :mod:`innr_tpu_torch.parallel` that merges K1's candidates
across scans runs the same local step, K1's raw keys with global row
indices: on a CUDA tensor the kernel (:func:`innr_tpu_torch.kernels.knn.
fused_knn_keys_batch`), on a CPU tensor its plain version; there is no
counterpart of the JAX package's ``use_fused`` arm split. The merge of the
candidates is :func:`innr_tpu_torch.utils.order.merge_parts` and the decode
of the winners :func:`innr_tpu_torch.kernels.knn.decode_keys`, as for every
other index.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.utils.asserts import ContractError

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
