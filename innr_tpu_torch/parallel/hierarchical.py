"""Two-level (dcn x ici) sharded corpus with a hierarchical top-k merge.

The counterpart of :mod:`innr_tpu.parallel.hierarchical`. Rows shard over
a 2-D mesh ``(dcn: n_slices, ici: per_slice)`` in row-major order, with
the JAX package's row ranges without its padding. A query merges in two
stages:

1. inside each ``ici`` group: the group's shards' (key, global index)
   candidates merge on the group's first device to the group's top-k;
2. across ``dcn``: one list per group (k candidates each, never ``ici x
   k``) merges on the mesh's first device.

Raw int32 total-order keys flow through both stages undecoded, and every
selection breaks ties toward the lower global index, so the result equals
the flat single-stage merge bit for bit, and a single-device scan of the
concatenated corpus, NaN rows across slices included.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedCorpus,
    _check,
    _empty,
    _local_keys,
    on_device,
    per_device,
    visible_devices,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import merge_parts

__all__ = ["HierarchicalCorpus", "hierarchical_mesh"]

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def hierarchical_mesh(n_slices: int, per_slice: int | None = None, devices=None) -> Mesh:
    """A (dcn: n_slices, ici: per_slice) mesh over the given devices
    (default: every visible card; a device may repeat)."""
    devices = np.asarray(visible_devices() if devices is None else list(devices),
                         dtype=object).reshape(-1)
    if per_slice is None:
        if devices.size % n_slices:
            raise ContractError(
                f"hierarchical_mesh: {devices.size} devices not divisible into {n_slices} "
                f"slices")
        per_slice = devices.size // n_slices
    if devices.size != n_slices * per_slice:
        raise ContractError(
            f"hierarchical_mesh: {devices.size} devices != {n_slices} x {per_slice}")
    return Mesh(devices.reshape(n_slices, per_slice), (DCN_AXIS, ICI_AXIS))


class HierarchicalCorpus(ShardedCorpus):
    """An (N, D) corpus sharded over a 2-level (dcn x ici) mesh with the
    two-stage top-k merge. The API mirrors :class:`ShardedCorpus` (dot, L2
    and cosine; (D,) or (Q, D) queries)."""

    def __init__(self, rows, mesh: Mesh | None = None, n_slices: int = 2,
                 dtype=torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ContractError("HierarchicalCorpus: dtype must be float32 or bfloat16")
        mesh = mesh if mesh is not None else hierarchical_mesh(n_slices)
        if tuple(mesh.axis_names) != (DCN_AXIS, ICI_AXIS):
            raise ContractError("HierarchicalCorpus: mesh axes must be ('dcn', 'ici')")
        super().__init__(rows, mesh, dtype)

    def _run(self, query, k: int, mode: str, op: str):
        q, k = _check(query, self, k, op)
        if k == 0:
            return _empty(q)
        qs = q if q.dim() == 2 else q[None, :]
        if qs.shape[0] == 0:
            return _empty(q, k)
        if mode == "cosine":
            qs = _knn._unit_queries(qs)
        flat = self.mesh.flat()
        on = per_device(qs, flat)
        per_slice = int(self.mesh.shape[ICI_AXIS])
        slices = []
        for g in range(int(self.mesh.shape[DCN_AXIS])):
            parts = []
            for i in range(g * per_slice, (g + 1) * per_slice):
                s, e = self.ranges[i]
                if e > s:
                    with on_device(flat[i]):
                        parts.append(_local_keys(self, i, on[flat[i]], min(k, e - s), mode,
                                                 False))
            if parts:
                lead = flat[g * per_slice]
                k_slice = min(k, sum(p[0].shape[1] for p in parts))
                with on_device(lead):
                    # Stage 1: this slice's top-k, on its own first device.
                    slices.append(merge_parts(parts, k_slice, lead))
        # Stage 2: one list per slice, merged on the mesh's first device.
        keys, idx = merge_parts(slices, k, qs.device)
        vals = _knn.decode_keys(keys, mode, qs)
        return (vals[0], idx[0]) if q.dim() == 1 else (vals, idx)

    def knn_dot(self, query, k: int):
        """Two-level MIPS top-k (scores descending, global indices), bit for
        bit the flat merge."""
        return self._run(query, k, "dot", "hierarchical_knn_dot")

    def knn_l2(self, query, k: int):
        """Two-level L2^2 top-k (ascending)."""
        return self._run(query, k, "l2", "hierarchical_knn_l2")

    def knn_cosine(self, query, k: int):
        """Two-level cosine top-k (descending)."""
        return self._run(query, k, "cosine", "hierarchical_knn_cosine")
