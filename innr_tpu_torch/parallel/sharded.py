"""Sharded corpus container and its kNN across shards.

The counterpart of :mod:`innr_tpu.parallel.sharded`. The JAX package is
single-controller: one Python call drives every device of a ``Mesh``
through ``shard_map``. So is this one. A :class:`Mesh` is a tuple of
``torch.device``s shaped to the JAX mesh's axis names, and a container
holds one tensor per shard, each on its shard's device. A kNN query runs
as:

1. each shard's local scan on its own device, on that device's current
   stream, with no host synchronisation between shards: K1 (the fused
   score + top-k kernel, :func:`innr_tpu_torch.parallel._scan.
   local_scan_keys`) for a CUDA shard, its plain version for a CPU shard;
   K14 over the shard's own tile summaries with ``prune=True``;
2. the per-shard (Q, k) pairs of (raw int32 total-order key, global row
   index) copied to the mesh's first device and merged there by
   :func:`innr_tpu_torch.utils.order.merge_parts` (one ``torch.topk``
   over int64 composites);
3. one decode of the winners' keys back to float32 scores
   (:func:`innr_tpu_torch.kernels.knn.decode_keys`).

Selection uses the same keys as the single-device scan and ties go to the
lowest global row, so the result is bit-identical to a single-device scan
of the concatenated corpus.

A mesh may list one device several times: shards on one device are then
separate tensors scanned in turn. The CPU is used only when asked for
(``default_mesh(["cpu"] * 8)``, or ``config.set_default_device("cpu")``,
which gives a one-shard mesh).

Shards without padding rows. The JAX package pads N up to a multiple of
the mesh size and fetches ``k + pad`` candidates per shard so that a
padding row never wins. Shards here are separate tensors, so they keep the
JAX row ranges with the padding cut off: shard i holds rows ``[i s,
min(N, (i + 1) s))`` with ``s = ceil(N / shards)`` (at least 1), a shard
with no rows is skipped, and each shard fetches ``min(k, its rows)``
candidates. ``shard_rows`` keeps the JAX value ``s``; ``memory_bytes()``
counts the bytes actually held (no padding rows).
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from innr_tpu_torch.batch import VerticalBatch
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.kernels import pruned_knn as _pruned
from innr_tpu_torch.parallel._scan import (
    local_scan_keys,
    local_scan_keys_filtered,
    resolve_predicate_mask,
)
from innr_tpu_torch.parallel._stream import fetch_block
from innr_tpu_torch.prune import build_tile_summary
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import composite_keys, merge_parts, total_order_key_f32
from innr_tpu_torch.utils.padding import round_up
from innr_tpu_torch.utils.tensors import empty_topk, host_device

__all__ = [
    "Mesh",
    "ShardedCorpus",
    "default_mesh",
    "sharded_knn_dot",
    "sharded_knn_l2",
    "sharded_knn_cosine",
    "sharded_knn_filtered",
]

AXIS = "shards"


class Mesh:
    """Devices shaped to named axes: the single-controller counterpart of a
    ``jax.sharding.Mesh``. ``devices`` is a numpy object array of
    ``torch.device`` (entries may repeat), ``axis_names`` one name per
    axis, ``shape`` the axis sizes by name."""

    def __init__(self, devices, axis_names):
        shape = np.shape(np.asarray(devices, dtype=object))
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        if not flat:
            raise ContractError("Mesh: needs at least one device")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ContractError(
                f"Mesh: {self.devices.ndim}-D devices for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """The devices in row-major order: shard i's device is ``flat()[i]``."""
        return list(self.devices.reshape(-1))

    def distinct(self) -> list:
        """Each device once, in order of first appearance."""
        return list(dict.fromkeys(self.flat()))

    def __repr__(self) -> str:  # pragma: no cover
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat()]})"


def visible_devices() -> list:
    """Every visible card when the default device is CUDA (raises without
    one: there is no fallback), else the default device alone."""
    dev = host_device(None)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def default_mesh(devices=None) -> Mesh:
    """1-D mesh over every visible card (or the given devices, e.g.
    ``["cpu"] * 8`` or ``["cuda:0"] * 4``), axis name ``"shards"``."""
    devices = visible_devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices, dtype=object).reshape(-1), (AXIS,))


def shard_rows_of(n: int, n_shards: int) -> int:
    """The JAX package's rows per shard: ``ceil(N / shards)``, at least 1."""
    return round_up(max(int(n), n_shards), n_shards) // n_shards


def shard_ranges(n: int, n_shards: int) -> list:
    """``(start, stop)`` of each shard's rows: the JAX package's ranges with
    the padding cut off (trailing shards may be empty)."""
    s = shard_rows_of(n, n_shards)
    return [(min(n, i * s), min(n, (i + 1) * s)) for i in range(n_shards)]


def on_device(dev):
    """Make ``dev`` current for a CUDA shard's launches (a no-op context on
    the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def per_device(t, devices) -> dict:
    """``t`` on each distinct device of ``devices`` (one copy per device)."""
    return {d: t.to(d, non_blocking=True) for d in dict.fromkeys(devices)}


def local_top(scores, k: int, base: int):
    """A shard's k best of (Q, n) float32 scores by total-order key, ties to
    the lower row: ``(keys, global idx)`` int32, for :func:`merge_parts`."""
    keys = total_order_key_f32(scores)
    rows = torch.arange(scores.shape[1], device=scores.device)
    pos = torch.topk(composite_keys(keys, rows), k, dim=1).indices
    return torch.gather(keys, 1, pos), (pos + base).to(torch.int32)


def aux_of(batch: VerticalBatch, mode: str):
    """K1's per-row stream of ``mode`` for a batch: its cached squared norms
    (l2), guarded inverse norms (cosine), or None (dot)."""
    if mode == "l2":
        return batch.norms2()
    return batch.inv_norms() if mode == "cosine" else None


def host_mask(mask, s: int, e: int, dev):
    """Rows [s, e) of a host boolean predicate mask as a bool tensor on
    ``dev`` (the filtered scans widen it on the device)."""
    return torch.from_numpy(np.ascontiguousarray(mask[s:e])).to(dev, non_blocking=True)


def as_queries(query, dim: int, dev, op: str, ranks=(1, 2)):
    """``query`` as a float32 tensor on ``dev`` of rank in ``ranks`` and last
    dimension ``dim``; raises :class:`ContractError` naming ``op``."""
    if isinstance(query, torch.Tensor):
        q = query.to(device=dev, dtype=torch.float32)
    else:
        q = torch.as_tensor(np.asarray(query, dtype=np.float32), device=dev)
    if q.dim() not in ranks or q.shape[-1] != dim:
        raise ContractError(
            f"innr_tpu_torch::{op}: query shape {tuple(q.shape)} != dimension {dim}")
    return q.contiguous()


def host_rows(rows):
    """Host data as a numpy array (a bfloat16 array keeps its dtype); a
    tensor as it is."""
    if isinstance(rows, torch.Tensor):
        return rows
    arr = np.asarray(rows)
    return arr if arr.dtype.name == "bfloat16" else np.asarray(arr, dtype=np.float32)


class ShardedCorpus:
    """An (N, D) corpus sharded row-wise across a :class:`Mesh`.

    The multi-device analog of :class:`innr_tpu_torch.batch.VerticalBatch`:
    shard i is a ``VerticalBatch`` on ``mesh.flat()[i]`` (with its own norm
    caches); queries go to every shard's device, results merge on the
    mesh's first device. A tensor's row slices on the shard's device are
    views (no copy); host data goes to each device one shard at a time.
    ``num_vectors`` / ``dimension`` report the corpus shape."""

    def __init__(self, rows, mesh: Mesh | None = None, dtype=torch.float32):
        """``dtype=torch.bfloat16`` stores the shards half-precision."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ContractError("ShardedCorpus: dtype must be float32 or bfloat16")
        rows = host_rows(rows)
        if rows.ndim != 2:
            raise ContractError("ShardedCorpus: rows must be 2-D (N, D)")
        self._setup(mesh, int(rows.shape[0]), int(rows.shape[1]), dtype)
        self.shards = [VerticalBatch(rows[s:e], dtype=dtype, device=d)
                       for d, (s, e) in zip(self.mesh.flat(), self.ranges)]

    def _setup(self, mesh, n: int, d: int, dtype) -> None:
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_true = n
        self._dim = d
        self._dtype = dtype
        self.ranges = shard_ranges(n, self.mesh.size)
        self._summaries = {}
        self._prune_tile_n = None

    @classmethod
    def from_row_source(cls, get_rows, num_vectors: int, dimension: int,
                        mesh: Mesh | None = None) -> "ShardedCorpus":
        """Build a sharded corpus WITHOUT materialising it on the host.

        ``get_rows(start, stop)`` returns rows ``[start, stop)`` as a
        ``(stop - start, dimension)`` f32 array (e.g. a ``np.memmap``
        slice). Each shard is fetched on its own and goes straight to its
        device; an empty shard never calls ``get_rows``."""
        self = cls.__new__(cls)
        self._setup(mesh, int(num_vectors), int(dimension), torch.float32)
        self.shards = []
        for d, (s, e) in zip(self.mesh.flat(), self.ranges):
            block = (fetch_block(get_rows, s, e, self._dim, np.float32, "from_row_source")
                     if e > s else np.zeros((0, self._dim), np.float32))
            self.shards.append(VerticalBatch(block, device=d))
        return self

    @property
    def num_vectors(self) -> int:
        return self.n_true

    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def shard_rows(self) -> int:
        """The JAX package's rows per shard, ``ceil(N / shards)``."""
        return shard_rows_of(self.n_true, self.mesh.size)

    def memory_bytes(self) -> int:
        """Bytes of the shards' rows (no padding rows are held)."""
        return sum(b.rows.numel() * b.rows.element_size() for b in self.shards)

    def set_prune_tile_n(self, tile_n) -> "ShardedCorpus":
        """Override the per-shard pruning tile height: rounded up to 128 and
        capped at ``pruned_tile_n(shard_rows, D)``, as the JAX package does;
        ``None`` resets. Exactness never depends on it. Clears the cached
        summaries; returns self."""
        if tile_n is not None:
            tile_n = int(tile_n)
            if tile_n <= 0:
                raise ContractError("set_prune_tile_n: tile_n must be positive or None")
            cap = _pruned.pruned_tile_n(self.shard_rows, self._dim, self._dtype)
            tile_n = min(round_up(tile_n, 128), cap)
        self._prune_tile_n = tile_n
        self._summaries = {}
        return self

    def tile_summary(self, normalized: bool = False) -> list:
        """Per-shard tile summaries for tile-skip pruning, each built on its
        shard's device from its own rows and cached: a list of
        :class:`~innr_tpu_torch.prune.TileSummary` (None for an empty
        shard), all of the JAX package's tile height
        (``pruned_tile_n(shard_rows, D)`` unless overridden)."""
        key = bool(normalized)
        if key not in self._summaries:
            tile_n = self._prune_tile_n or _pruned.pruned_tile_n(
                self.shard_rows, self._dim, self._dtype)
            self._summaries[key] = [
                build_tile_summary(b.rows, tile_n, normalized=key) if b.num_vectors else None
                for b in self.shards]
        return self._summaries[key]

    def _across(self, keys, idx, k: int):
        """The merge across processes: none in one process (the process
        corpus of :mod:`~innr_tpu_torch.parallel.multihost` gathers here)."""
        return keys, idx

    def knn_dot(self, query, k: int, prune: bool = False):
        """Sharded MIPS top-k: ``(scores descending, global indices)``
        tensors on the mesh's first device. ``prune=True``: each shard
        runs the tile-skip scan over its own tile summaries, exact."""
        return sharded_knn_dot(query, self, k, prune=prune)

    def knn_l2(self, query, k: int, prune: bool = False):
        """Sharded L2^2 top-k: ``(distances ascending, global indices)``."""
        return sharded_knn_l2(query, self, k, prune=prune)

    def knn_cosine(self, query, k: int, prune: bool = False):
        """Sharded cosine top-k: ``(similarities descending, global
        indices)``; zero-norm rows and queries score 0.0."""
        return sharded_knn_cosine(query, self, k, prune=prune)

    def knn_filtered(self, query, k: int, predicate):
        """Sharded L2^2 kNN with predicate pushdown, among passing rows
        only. ``predicate``: an (N,) boolean mask over global row indices,
        or a host callable ``index -> bool``."""
        return sharded_knn_filtered(query, self, k, predicate)


def _empty(q, k: int = 0):
    return empty_topk((0,) if q.dim() == 1 else (int(q.shape[0]), k), q.device)


def _check(query, corpus: ShardedCorpus, k: int, op: str):
    q = as_queries(query, corpus.dimension, corpus.mesh.flat()[0], op)
    if k <= 0 or corpus.num_vectors == 0:
        return q, 0
    return q, min(int(k), corpus.num_vectors)


def _local_keys(corpus: ShardedCorpus, i: int, qs, k: int, mode: str, prune: bool):
    """Shard i's ``(keys, global idx)`` (Q, k): K14 over its survivor tiles
    when pruning and k fits one pass (as the JAX package routes), else K1."""
    b = corpus.shards[i]
    base = corpus.ranges[i][0]
    aux = aux_of(b, mode)
    if prune and k <= _knn.single_pass_k(qs.shape[0]):
        summary = corpus.tile_summary(normalized=mode == "cosine")[i]
        order, n_surv = _pruned.plan(qs, b.rows, summary, k, mode)
        keys, lidx = _pruned.pruned_keys(qs, b.rows, aux, order, n_surv, summary.tile_n, k, mode)
        return keys, lidx + base
    return local_scan_keys(qs, b.rows, aux, corpus.n_true, k, mode, base)


def _run(query, corpus: ShardedCorpus, k: int, mode: str, op: str, prune: bool = False):
    q, k = _check(query, corpus, k, op)
    if k == 0:
        return _empty(q)
    qs = q if q.dim() == 2 else q[None, :]
    if qs.shape[0] == 0:
        return _empty(q, k)
    if mode == "cosine":
        qs = _knn._unit_queries(qs)
    on = per_device(qs, corpus.mesh.flat())
    parts = []
    for i, (d, (s, e)) in enumerate(zip(corpus.mesh.flat(), corpus.ranges)):
        if e > s:
            with on_device(d):
                parts.append(_local_keys(corpus, i, on[d], min(k, e - s), mode, prune))
    keys, idx = corpus._across(*_merge_local(parts, k, qs), k)
    vals = _knn.decode_keys(keys, mode, qs)
    return (vals[0], idx[0]) if q.dim() == 1 else (vals, idx)


def _merge_local(parts, k: int, qs):
    """This process's merge: at most k of its shards' candidates, on the
    queries' device (an empty (Q, 0) pair when it holds none)."""
    if not parts:
        z = torch.zeros((qs.shape[0], 0), dtype=torch.int32, device=qs.device)
        return z, z
    return merge_parts(parts, min(k, sum(p[0].shape[1] for p in parts)), qs.device)


def sharded_knn_dot(query, corpus: ShardedCorpus, k: int, prune: bool = False):
    """Sharded ``batch_knn_dot`` over a :class:`ShardedCorpus`. ``query``
    may be (D,) or a (Q, D) batch: all queries share each shard's scan and
    the one merge."""
    return _run(query, corpus, k, "dot", "sharded_knn_dot", prune=prune)


def sharded_knn_l2(query, corpus: ShardedCorpus, k: int, prune: bool = False):
    """Sharded ``batch_knn`` (L2^2) over a :class:`ShardedCorpus`."""
    return _run(query, corpus, k, "l2", "sharded_knn_l2", prune=prune)


def sharded_knn_cosine(query, corpus: ShardedCorpus, k: int, prune: bool = False):
    """Sharded ``batch_knn_cosine``; zero-norm semantics as the
    single-device scan (unit queries)."""
    return _run(query, corpus, k, "cosine", "sharded_knn_cosine", prune=prune)


def sharded_knn_filtered(query, corpus: ShardedCorpus, k: int, predicate):
    """Sharded ``batch_knn_filtered``: exact L2^2 kNN among predicate-
    passing rows, the mask pushed into each shard's scan (K1's masked
    mode). ``predicate``: (N,) boolean mask over global row indices, or a
    host callable ``index -> bool``. Returns at most ``min(k,
    num_passing)`` results per query; a shard with no passing row is not
    scanned, and each other shard fetches at most its passing count."""
    q, k = _check(query, corpus, k, "sharded_knn_filtered")
    if k == 0:
        return _empty(q)
    mask, num_passing = resolve_predicate_mask(predicate, corpus.num_vectors,
                                               "sharded_knn_filtered")
    if num_passing == 0:
        return _empty(q)
    k = min(k, num_passing)
    qs = q if q.dim() == 2 else q[None, :]
    if qs.shape[0] == 0:
        return _empty(q, k)
    on = per_device(qs, corpus.mesh.flat())
    parts = []
    for i, (d, (s, e)) in enumerate(zip(corpus.mesh.flat(), corpus.ranges)):
        passing = int(mask[s:e].sum())
        if passing:
            b = corpus.shards[i]
            with on_device(d):
                parts.append(local_scan_keys_filtered(on[d], b.rows, b.norms2(),
                                                      host_mask(mask, s, e, d), corpus.n_true,
                                                      min(k, passing), s))
    keys, idx = corpus._across(*_merge_local(parts, k, qs), k)
    vals = _knn.decode_keys(keys, "l2", qs)
    return (vals[0], idx[0]) if q.dim() == 1 else (vals, idx)
