"""IVF-layout exact kNN index: tile-aligned cluster segments and the pruned
scan.

The counterpart of :mod:`innr_tpu.ivf`. A plain cluster reorder leaves
cluster boundaries inside pruning tiles; :class:`IVFIndex` pads every
cluster segment to a multiple of the tile height, so no tile straddles two
clusters and each tile's centroid/radius summary describes one cluster:

- **Exact results.** The pruned scan skips a tile only when no row in it
  can enter the top-k (:mod:`innr_tpu_torch.prune`); there is no
  ``nprobe`` recall knob, and results equal a full scan of the original
  corpus.
- **Padding rows never win.** They are left out of the tile summary
  (``row_valid``) and pinned to the worst key in the scan (K1's masked
  modes "dotm" / "l2m" / "cosinem").
- **Ties go to the lowest original index.** The scans select on (key,
  original index): each layout row's original index rides in its
  composite (the kernels' row-id map; padding rows take distinct ids
  counting down from INT32_MAX), so a tie between two clusters resolves as
  in a scan of the original order, whatever the layout.
- **All-device build.** Fit, assignment and the padded scatter run on the
  corpus's device; only the per-cluster sizes (kc ints) go to the host, to
  fix the padded shape.

k-means draws come from a ``torch.Generator`` and differ from the JAX
package's, so the two packages' layouts differ; their search results do
not.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch.batch import BatchKnnResult
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.kernels import pruned_knn as _pruned
from innr_tpu_torch.prune import (
    _kmeans_assign,
    _kmeans_params,
    build_tile_summary,
    sort_assign,
)
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.padding import round_up
from innr_tpu_torch.utils.tensors import as_tensor, to_host

__all__ = ["IVFIndex"]

_MODES = {"dot": "dotm", "l2": "l2m", "cosine": "cosinem"}


def _pick_tile(sizes: np.ndarray, n: int, d: int, dtype) -> int:
    """Tile height of an aligned layout: the median non-empty cluster size
    rounded to a multiple of 128, within [256, ``pruned_tile_n``] (the JAX
    package's rule)."""
    cap = _pruned.pruned_tile_n(max(n, 1), d, dtype)
    nz = sizes[sizes > 0]
    if nz.size == 0:
        return max(256, min(cap, 4096))
    med = float(np.median(nz))
    tile = max(128, int(round(med / 128.0)) * 128)
    return int(max(256, min(tile, cap)))


def _scatter_layout(rows, sorted_assign, perm, offsets, starts, n_pad: int):
    """Rows into the padded aligned layout, on the device: cluster c's
    rows, in corpus order, start at ``offsets[c]``. Returns ``(rows
    (n_pad, D), orig_idx (n_pad,) int32)`` with -1 on padding rows. Each
    row is copied once, straight into its slot."""
    n = sorted_assign.shape[0]
    rank = torch.arange(n, device=perm.device) - starts[sorted_assign]
    dest = offsets[sorted_assign] + rank  # slot of the row perm[i]
    dest_of_row = torch.empty_like(dest)
    dest_of_row[perm] = dest
    out = torch.zeros((n_pad, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    out.index_copy_(0, dest_of_row, rows)
    orig = torch.full((n_pad,), -1, dtype=torch.int32, device=rows.device)
    orig[dest] = perm.to(torch.int32)
    return out, orig


class IVFIndex:
    """Exact kNN over a cluster-padded corpus layout (see the module doc).

    ``metric``: "dot" (scores descending), "l2" (squared distances
    ascending) or "cosine" (descending; zero-norm rows and queries score
    0.0). ``dtype=torch.bfloat16`` stores the padded corpus in half
    precision. Host data goes to ``device`` (default
    :func:`innr_tpu_torch.config.default_device`, the card); a tensor
    stays on its device unless ``device`` is given.
    """

    __slots__ = ("metric", "rows", "tile_n", "n_true",
                 "_valid", "_ids", "_aux", "_summary", "cluster_sizes")

    def __init__(self, rows, n_clusters: int = 256, metric: str = "dot",
                 tile_n: int | None = None, dtype=torch.float32, n_iters: int = 5,
                 seed: int = 0, sample: int = 65536, device=None):
        if metric not in _MODES:
            raise ContractError(
                f"IVFIndex: metric must be one of {sorted(_MODES)}, got {metric!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ContractError("IVFIndex: dtype must be float32 or bfloat16")
        if not isinstance(rows, torch.Tensor):
            rows = as_tensor(rows, torch.float32, device)
        elif device is not None:
            rows = rows.to(device)
        if rows.dim() != 2 or rows.shape[0] == 0:
            raise ContractError(
                f"IVFIndex: rows must be a non-empty (N, D) array, got {tuple(rows.shape)}")
        self.metric = metric
        n, d = int(rows.shape[0]), int(rows.shape[1])
        self.n_true = n

        r, kc, m = _kmeans_params(rows, n_clusters, sample)
        assign = _kmeans_assign(r, seed, n_iters, kc, m)
        sorted_assign, perm, sizes_dev = sort_assign(assign, kc)
        sizes = sizes_dev.cpu().numpy()  # host: kc ints (fixes the shape)
        self.cluster_sizes = sizes
        tile = int(tile_n) if tile_n is not None else _pick_tile(sizes, n, d, dtype)
        if tile <= 0:
            raise ContractError("IVFIndex: tile_n must be positive")
        self.tile_n = tile

        padded = -(-sizes.astype(np.int64) // tile) * tile  # per cluster; 0 stays 0
        n_pad = int(round_up(max(int(padded.sum()), tile), tile))
        dev = rows.device
        offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(padded)[:-1]]), device=dev)
        starts = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64),
                                 device=dev)
        self.rows, orig_idx = _scatter_layout(
            rows.to(dtype).contiguous(), sorted_assign, perm, offsets, starts, n_pad)
        self._valid = orig_idx >= 0
        # The scans' row-id map: the original index, distinct ids counting
        # down from INT32_MAX on padding rows (composites stay unique).
        pad_ids = 2**31 - torch.cumsum((~self._valid).to(torch.int32), 0)
        self._ids = torch.where(self._valid, orig_idx, pad_ids.to(torch.int32))
        validf = self._valid.to(torch.float32)
        if metric == "dot":
            self._aux = validf
        elif metric == "l2":
            self._aux = torch.stack([_knn._norms2(self.rows), validf])
        else:
            self._aux = torch.stack([_knn.inv_norms(self.rows), validf])
        self._summary = build_tile_summary(
            self.rows, tile, normalized=(metric == "cosine"), row_valid=self._valid)

    # -- introspection -------------------------------------------------------

    @property
    def orig_idx(self) -> torch.Tensor:
        """(n_pad,) int32: each layout row's index in the constructor's
        order, -1 on padding rows."""
        return torch.where(self._valid, self._ids, -1)

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    @property
    def padding_fraction(self) -> float:
        """Fraction of stored rows that are alignment padding."""
        return 1.0 - self.n_true / int(self.rows.shape[0])

    def memory_bytes(self) -> int:
        return (self.rows.numel() * self.rows.element_size()
                + self._ids.numel() * 4
                + self._aux.numel() * 4
                + self._summary.memory_bytes())

    def _plan_queries(self, qs):
        if self.metric == "cosine":
            qs = _knn._unit_queries(qs)
        return qs

    def plan_stats(self, queries, k: int) -> tuple[int, int]:
        """``(surviving_tiles, total_tiles)`` the pruned scan reads for this
        batch (a host sync: for diagnostics, not serving)."""
        qs = self._plan_queries(self._queries(queries))
        _, n_surv = _pruned.plan(qs, self.rows, self._summary, min(int(k), self.n_true),
                                 _MODES[self.metric])
        return int(n_surv), self._summary.n_tiles

    # -- search ---------------------------------------------------------------

    def _queries(self, queries) -> torch.Tensor:
        qs = as_tensor(queries, torch.float32, self.rows.device)
        if qs.dim() == 1:
            qs = qs[None, :]
        if qs.dim() != 2 or qs.shape[1] != self.dimension:
            raise ContractError(
                f"IVFIndex: queries shape {tuple(qs.shape)} != (Q, {self.dimension})")
        return qs.contiguous()

    def search_batch(self, queries, k: int) -> BatchKnnResult:
        """Exact top-k for a (Q, D) batch: plan and tile scan on the
        device, selecting on (key, original index), then one host copy of
        the ``(scores, original indices)`` pair. Indices refer to the row
        order passed to the constructor; ties go to the lowest."""
        qs = self._queries(queries)
        n_q = int(qs.shape[0])
        if k <= 0 or n_q == 0:
            return BatchKnnResult(indices=np.zeros((n_q, 0), np.int64),
                                  scores=np.zeros((n_q, 0), np.float32))
        k = min(int(k), self.n_true)
        vals, orig = _pruned._pruned_run(self._plan_queries(qs), self.rows, self._aux,
                                         self._summary, k, _MODES[self.metric], self._ids)
        scores, indices = to_host(vals, orig)
        return BatchKnnResult(indices=indices, scores=scores)

    def search(self, query, k: int) -> BatchKnnResult:
        """Single-query :meth:`search_batch` (1-D in, 1-D out)."""
        res = self.search_batch(as_tensor(query, torch.float32, self.rows.device)[None, :], k)
        return BatchKnnResult(indices=res.indices[0], scores=res.scores[0])
