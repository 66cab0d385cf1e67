"""Tile summaries, survivor planning and the k-means layout passes.

The counterpart of :mod:`innr_tpu.prune`. Each corpus tile of ``tile_n``
rows is summarised by its centroid ``c`` and covering radius ``r = max_i
||row_i - c||``; Cauchy-Schwarz then bounds every score in the tile:

- dot:  ``q.c - |q| r  <=  q.row  <=  q.c + |q| r``
- L2^2: ``(max(0, ||q-c|| - r))^2  <=  ||q-row||^2  <=  (||q-c|| + r)^2``

Ranking tiles by their guaranteed bound and accumulating row counts until
k rows are covered gives a threshold ``t0`` that at least k rows reach; a
tile whose optimistic bound misses ``t0`` by more than the rounding slack
(``config.PRUNE_BOUND_EPS``) for every query holds no top-k row, and the
pruned scan (:mod:`innr_tpu_torch.kernels.pruned_knn`) never reads it.
Results are exact. The plans stay on the device: :func:`plan_survivors`
returns ``(order, n_surv)`` as tensors and nothing here waits for the
host.

Pruning needs tile coherence. :func:`cluster_reorder` (and
:func:`cluster_order`) lay a corpus out by nearest k-means centroid: a
sampled k-means++ fit (its kc - 1 seeding steps replayed as one CUDA graph
on the card, :func:`kmeanspp_seed`), Lloyd steps on the sample, then one
full pass of the nearest-centroid kernel
(:mod:`innr_tpu_torch.kernels.assign`). Draws come
from a ``torch.Generator`` seeded with ``seed``; they differ from
``jax.random``'s, so the two packages' layouts differ (each is a valid
clustering; results of the exact scans do not depend on the layout).
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch import config
from innr_tpu_torch.kernels.assign import nearest_centroid
from innr_tpu_torch.utils.padding import round_up
from innr_tpu_torch.utils.tensors import host_device

__all__ = [
    "TileSummary",
    "build_tile_summary",
    "plan_survivors",
    "plan_threshold_survivors",
    "cluster_order",
    "cluster_reorder",
    "suggest_tile_n",
]

# Elements of corpus the summary pass holds at a time.
_SUMMARY_CHUNK = 1 << 24


class TileSummary:
    """Per-tile (centroid, radius, row count) summary of an (N, D) corpus,
    built for one tiling: ``tile_n`` is the scan's tile height."""

    __slots__ = ("tile_n", "centroids", "radii", "counts", "n_rows")

    def __init__(self, tile_n, centroids, radii, counts, n_rows):
        self.tile_n = int(tile_n)
        self.centroids = centroids  # (n_tiles, D) float32
        self.radii = radii          # (n_tiles,) float32
        self.counts = counts        # (n_tiles,) int32 rows per tile
        self.n_rows = int(n_rows)

    @classmethod
    def from_numpy(cls, tile_n, centroids, radii, counts, n_rows, device=None) -> "TileSummary":
        """From host arrays, e.g. ``np.asarray`` of an ``innr_tpu``
        summary's ``centroids``, ``radii`` and ``counts``, onto ``device``
        (default: the default device, the card)."""
        dev = host_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.array(a), device=dev).to(dtype)

        return cls(tile_n, t(centroids, torch.float32), t(radii, torch.float32),
                   t(counts, torch.int32), n_rows)

    @property
    def n_tiles(self) -> int:
        return int(self.centroids.shape[0])

    def memory_bytes(self) -> int:
        return 4 * (self.centroids.numel() + self.radii.numel() + self.counts.numel())


def _summarize(r, valid):
    """(centroids, radii, counts) of the tiles ``r`` (T, tile_n, D) float32
    over their rows where ``valid`` (T, tile_n)."""
    cnt = valid.sum(dim=1).to(torch.int32)
    v = valid[..., None]
    cent = torch.where(v, r, 0.0).sum(dim=1) / cnt.clamp_min(1).to(torch.float32)[:, None]
    diff = r - cent[:, None, :]
    d2 = torch.where(valid, (diff * diff).sum(dim=2), 0.0)
    return cent, torch.sqrt(d2.max(dim=1).values), cnt


def build_tile_summary(rows, tile_n: int, normalized: bool = False,
                       row_valid=None) -> TileSummary:
    """One pass over the corpus -> :class:`TileSummary` on its device.

    The ragged last tile is summarised over its real rows. A NaN or inf
    row poisons its tile's radius to NaN, and the planner never prunes
    such a tile. ``normalized=True`` summarises the unit rows (zero or
    tiny-norm rows become zero rows): the cosine scan plans as dot against
    it. ``row_valid`` (N,) bool: summarise only those rows (centroid,
    radius and count); tiles with no valid row get count 0 and are always
    dead. The corpus is read in chunks of whole tiles."""
    n, d = rows.shape
    tile_n = int(tile_n)
    n_tiles = -(-n // tile_n)
    dev = rows.device
    if row_valid is not None:
        row_valid = torch.as_tensor(row_valid, dtype=torch.bool, device=dev)
    cent = torch.empty((n_tiles, d), dtype=torch.float32, device=dev)
    radii = torch.empty(n_tiles, dtype=torch.float32, device=dev)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    per = max(1, _SUMMARY_CHUNK // max(1, tile_n * d))  # tiles per chunk
    for t0 in range(0, n_tiles, per):
        t1 = min(n_tiles, t0 + per)
        s, e = t0 * tile_n, min(n, t1 * tile_n)
        r = rows[s:e].float()
        if normalized:
            norms = torch.sqrt((r * r).sum(dim=1, keepdim=True))
            ok = norms > config.NORM_EPSILON
            r = torch.where(ok, r / torch.where(ok, norms, 1.0), 0.0)
        pad = (t1 - t0) * tile_n - (e - s)
        valid = torch.arange(s, s + (t1 - t0) * tile_n, device=dev) < n
        if pad:
            r = torch.cat([r, r.new_zeros((pad, d))])
        if row_valid is not None:
            rv = row_valid[s:e]
            valid &= torch.cat([rv, rv.new_zeros(pad)]) if pad else rv
        c, rad, cnt = _summarize(r.view(t1 - t0, tile_n, d), valid.view(t1 - t0, tile_n))
        cent[t0:t1], radii[t0:t1], counts[t0:t1] = c, rad, cnt
    return TileSummary(tile_n, cent, radii, counts, n)


def _pad_tail(order, n_surv, n_tiles: int):
    """Dead slots of ``order`` (positions >= ``n_surv``) repeat the last
    survivor's tile id, as in the JAX package (its pipeline then skips the
    re-fetch); the scan reads only the first ``n_surv`` slots."""
    last = order.index_select(0, (n_surv - 1).clamp_min(0).reshape(1).long())
    idxs = torch.arange(n_tiles, device=order.device)
    return torch.where(idxs < n_surv, order, last)


def _survivor_order(alive, n_tiles: int):
    """``(order, n_surv)``: alive tiles ascending first (a stable sort of
    ``~alive``), then the padded tail."""
    n_surv = alive.sum().to(torch.int32)
    order = torch.sort((~alive).to(torch.uint8), stable=True).indices.to(torch.int32)
    return _pad_tail(order, n_surv, n_tiles), n_surv


def plan_survivors(qs, cent, rad, cnt, k: int, mode: str, fast: bool = False):
    """Survivor tile plan for a (Q, D) query batch: ``(order (n_tiles,)
    int32, n_surv () int32)``, both on the device.

    Per query, tiles are ranked by their guaranteed bound and row counts
    accumulated until >= k rows are covered; ``t0`` is the guaranteed bound
    there. ``fast=True`` (valid when some tile holds >= k rows) takes ``t0``
    as the best guaranteed bound among tiles holding >= k rows: one masked
    max, no per-query sort. A tile is dead when its optimistic bound misses
    ``t0`` by more than the slack for every query; NaN bounds keep tiles
    alive, tiles with no rows are always dead. ``mode``: "dot" (larger is
    better) or "l2"."""
    n_tiles = cent.shape[0]
    qd = qs @ cent.T  # (Q, n_tiles)
    qn = torch.sqrt((qs * qs).sum(dim=1, keepdim=True))
    cc = (cent * cent).sum(dim=1)[None, :]
    r = rad[None, :]
    if mode == "dot":
        guaranteed = qd - qn * r
        optimistic = qd + qn * r
        gkeys = guaranteed
        slack = config.PRUNE_BOUND_EPS * qn * (torch.sqrt(cc) + r)
    else:
        qq = (qs * qs).sum(dim=1, keepdim=True)
        qc = torch.sqrt((qq + cc - 2.0 * qd).clamp_min(0.0))  # ||q - c||
        guaranteed = (qc + r) ** 2
        lower = (qc - r).clamp_min(0.0)
        optimistic = lower * lower
        gkeys = -guaranteed  # smallest guaranteed distance first
        slack = config.PRUNE_BOUND_EPS * (qq + cc + 2.0 * qd.abs())
    empty = (cnt <= 0)[None, :]
    gkeys = torch.where(empty, -torch.inf, gkeys)
    if fast:
        eligible = (cnt >= k)[None, :]
        masked = torch.where(eligible & ~torch.isnan(gkeys), gkeys, -torch.inf)
        t0 = masked.max(dim=1, keepdim=True).values
        if mode != "dot":
            t0 = -t0
    else:
        # Best guarantee first; NaN bounds last (they guarantee nothing).
        order_g = torch.sort(torch.where(torch.isnan(gkeys), torch.inf, -gkeys),
                             dim=1, stable=True).indices
        cum = torch.cumsum(cnt[order_g], dim=1)
        pos = (cum < k).sum(dim=1).clamp_max(n_tiles - 1)
        t0 = torch.gather(torch.gather(guaranteed, 1, order_g), 1, pos[:, None])
    if mode == "dot":
        dead_q = optimistic + slack < t0
    else:
        dead_q = optimistic > t0 + slack
    alive = ~dead_q.all(dim=0) & ~empty[0]
    return _survivor_order(alive, n_tiles)


def plan_threshold_survivors(qs, cent, rad, threshold):
    """Survivor plan for a fixed L2^2 threshold: a tile is dead when its
    lower bound ``(max(0, ||q-c|| - r))^2`` exceeds ``threshold`` plus the
    slack for every query. Returns ``(order, n_surv, alive)`` on the
    device."""
    n_tiles = cent.shape[0]
    qd = qs @ cent.T
    qq = (qs * qs).sum(dim=1, keepdim=True)
    cc = (cent * cent).sum(dim=1)[None, :]
    qc = torch.sqrt((qq + cc - 2.0 * qd).clamp_min(0.0))
    lower = (qc - rad[None, :]).clamp_min(0.0)
    slack = config.PRUNE_BOUND_EPS * (qq + cc + 2.0 * qd.abs())
    dead_q = lower * lower > float(np.float32(threshold)) + slack  # NaN -> alive
    alive = ~dead_q.all(dim=0)
    order, n_surv = _survivor_order(alive, n_tiles)
    return order, n_surv, alive


# ---------------------------------------------------------------------------
# k-means layout passes
# ---------------------------------------------------------------------------

def _as_rows(rows) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows
    return torch.as_tensor(np.asarray(rows, dtype=np.float32), device=host_device())


def _kmeans_params(rows, n_clusters: int, sample: int):
    rows = _as_rows(rows)
    n = int(rows.shape[0])
    n_clusters = int(min(n_clusters, max(n, 1)))
    m = int(min(n, max(sample, n_clusters)))
    return rows, n_clusters, m


def _cluster_sums(s, assign, kc: int) -> torch.Tensor:
    """Per-cluster sums of the sample rows: one-hot products over row
    chunks, in a fixed order (scatter-adds would sum in atomic order)."""
    sums = torch.zeros((kc, s.shape[1]), dtype=torch.float32, device=s.device)
    ids = torch.arange(kc, device=s.device)
    step = max(1, (1 << 24) // kc)
    for a in range(0, s.shape[0], step):
        one_hot = (assign[a:a + step, None] == ids[None, :]).to(torch.float32)
        sums += one_hot.T @ s[a:a + step]
    return sums


# k-means++ seeding steps per chunk: the unit a CUDA graph captures and
# replays.
SEED_CHUNK = 64


def _d2_to(ss, ssn, c):
    """Squared L2 of every seed-pool row to one centre, clamped at 0."""
    return torch.addmv(ssn + (c * c).sum(), ss, c, alpha=-2.0).clamp_min_(0.0)


def _seed_steps(ss, ssn, u, cent, mind2, j, steps: int) -> None:
    """``steps`` k-means++ steps, in place on fixed buffers: step ``j``
    (a (1,) device tensor) draws the next seed with probability
    proportional to its squared distance from the chosen set (non-finite
    distances, NaN rows, weigh as 0; every weight at least 1e-30) by
    inverse CDF of the uniform ``u[j]``, writes it to ``cent[j]`` and
    lowers ``mind2``. Nothing here waits for the host (ATen's
    ``multinomial`` reads a validation flag back on every call), so the
    steps can be captured in a CUDA graph."""
    last = ss.shape[0] - 1
    for _ in range(steps):
        w = torch.nan_to_num(mind2, nan=0.0, posinf=0.0).clamp_min_(1e-30)
        cdf = torch.cumsum(w, 0, dtype=torch.float64)
        target = u.index_select(0, j) * cdf[-1:]
        pick = torch.searchsorted(cdf, target, right=True).clamp_max_(last)
        c = ss.index_select(0, pick)
        cent.index_copy_(0, j, c)
        torch.minimum(mind2, _d2_to(ss, ssn, c[0]), out=mind2)
        j.add_(1)


def kmeanspp_seed(ss, gen, kc: int) -> torch.Tensor:
    """k-means++ seeds from the (m, D) float32 pool ``ss``: (kc, D) float32
    on its device. The first seed and all kc - 1 uniforms are drawn from
    ``gen`` up front; the steps run in chunks of :data:`SEED_CHUNK`, the
    first eagerly and the rest, on a CUDA device, as replays of one CUDA
    graph of a chunk (the CPU runs every chunk eagerly: the same steps).
    The buffers are padded to whole chunks; the padding steps draw
    ``u = 0`` and write rows past kc, which are dropped."""
    dev = ss.device
    m_seed, d = ss.shape
    ssn = (ss * ss).sum(dim=1)
    first = torch.randint(0, m_seed, (1,), generator=gen, device=dev)
    n_steps = round_up(kc - 1, SEED_CHUNK)
    u = torch.zeros(1 + n_steps, dtype=torch.float64, device=dev)
    u[1:kc] = torch.rand(kc - 1, generator=gen, dtype=torch.float64, device=dev)
    cent = torch.zeros((1 + n_steps, d), dtype=torch.float32, device=dev)
    cent[:1] = ss.index_select(0, first)
    mind2 = _d2_to(ss, ssn, cent[0])
    j = torch.ones(1, dtype=torch.int64, device=dev)

    def chunk():
        _seed_steps(ss, ssn, u, cent, mind2, j, SEED_CHUNK)

    chunks = n_steps // SEED_CHUNK
    if dev.type != "cuda" or chunks <= 1:
        for _ in range(chunks):
            chunk()
        return cent[:kc]
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        chunk()  # the first chunk, eagerly: it also warms up cuBLAS
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chunk()  # captured, not run
    for _ in range(chunks - 1):
        graph.replay()
    return cent[:kc]


def _kmeans_assign(r, seed: int, iters: int, kc: int, m: int) -> torch.Tensor:
    """Sampled k-means++ fit, ``iters`` Lloyd steps on the sample, then one
    full-corpus nearest-centroid pass -> (N,) int32 cluster ids, all on the
    corpus's device (shared by :func:`cluster_order`, :func:`cluster_reorder`
    and ``IVFIndex``)."""
    dev = r.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    n = r.shape[0]
    # With replacement: O(m), and duplicate draws do not hurt a fit.
    s = r[torch.randint(0, n, (m,), generator=gen, device=dev)].float()
    # k-means++ seeding on a prefix of the sample (itself a uniform draw).
    cent = kmeanspp_seed(s[:min(m, 8192)], gen, kc)
    for _ in range(iters):
        assign = nearest_centroid(s, cent)
        sums = _cluster_sums(s, assign, kc)
        cnts = torch.bincount(assign, minlength=kc).to(torch.float32)[:, None]
        cent = torch.where(cnts > 0, sums / cnts.clamp_min(1.0), cent)
    return nearest_centroid(r, cent)


def cluster_order(rows, n_clusters: int = 256, n_iters: int = 5, seed: int = 0,
                  sample: int = 65536) -> np.ndarray:
    """Host int64 permutation grouping rows by nearest k-means centroid
    (stable within a cluster). Prefer :func:`cluster_reorder`, which keeps
    every N-sized array on the device. The layout never changes a pruned
    scan's result, only how much it prunes."""
    rows, n_clusters, m = _kmeans_params(rows, n_clusters, sample)
    assign = _kmeans_assign(rows, seed, n_iters, n_clusters, m)
    return np.argsort(assign.cpu().numpy(), kind="stable")


def sort_assign(assign, kc: int):
    """``(sorted_assign, perm, sizes)`` from one stable sort of the cluster
    ids; ``sizes`` (kc,) int32 from kc + 1 binary searches. On the device."""
    sorted_assign, perm = torch.sort(assign.long(), stable=True)
    bounds = torch.searchsorted(sorted_assign,
                                torch.arange(kc + 1, device=assign.device), side="left")
    return sorted_assign, perm, torch.diff(bounds).to(torch.int32)


def cluster_reorder(rows, n_clusters: int = 256, n_iters: int = 5, seed: int = 0,
                    sample: int = 65536):
    """All-device layout pass: fit, assign, one stable sort and the row
    gather. Returns ``(reordered_rows, perm (N,) int32, cluster_sizes
    (n_clusters,) int32)`` on the corpus's device, with ``reordered_rows[i]
    == rows[perm[i]]`` (a kNN index ``j`` on the new rows maps back as
    ``perm[j]``). Needs twice the corpus bytes during the gather. Feed
    ``cluster_sizes`` to :func:`suggest_tile_n`, or use
    ``VerticalBatch.cluster_reorder``, which does both."""
    rows, n_clusters, m = _kmeans_params(rows, n_clusters, sample)
    assign = _kmeans_assign(rows, seed, n_iters, n_clusters, m)
    _, perm, sizes = sort_assign(assign, n_clusters)
    return rows.index_select(0, perm), perm.to(torch.int32), sizes


def suggest_tile_n(cluster_sizes, n: int, d: int, dtype=None) -> int:
    """Pruning tile height for a cluster-reordered corpus: half the 25th
    percentile of the non-empty cluster sizes, rounded down to a multiple
    of 128, floored at the rows of about 1 MB of corpus (at least 256) and
    capped at :func:`~innr_tpu_torch.kernels.pruned_knn.pruned_tile_n`. The
    JAX package's formula and cap, kept so that both packages build the
    same tiling; its floor was sized for the TPU's DMAs, and whether it
    suits the H100 is not measured."""
    from innr_tpu_torch.kernels.pruned_knn import pruned_tile_n

    dt = dtype if dtype is not None else torch.float32
    if isinstance(cluster_sizes, torch.Tensor):
        cluster_sizes = cluster_sizes.cpu().numpy()
    sizes = np.asarray(cluster_sizes)
    sizes = sizes[sizes > 0]
    cap = pruned_tile_n(n, d, dt)
    itemsize = 2 if dt == torch.bfloat16 else 4
    rows_1mb = -(-(1 << 20) // (max(d, 1) * itemsize))
    floor = max(256, round_up(rows_1mb, 128))
    if sizes.size == 0:
        return cap
    p25 = float(np.percentile(sizes, 25))
    tile = int(p25 / 2) // 128 * 128
    return int(max(floor, min(tile, cap)))
