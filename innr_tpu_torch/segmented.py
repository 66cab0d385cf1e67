"""Mutable serving index over immutable segments (the LSM pattern).

The counterpart of :mod:`innr_tpu.segmented`. :class:`SegmentedCorpus`
takes adds and deletes without rebuilding what it holds:

- ``add(rows)`` appends a new immutable segment (a
  :class:`~innr_tpu_torch.batch.VerticalBatch` on the corpus's device) and
  returns the permanent ids it assigned;
- ``delete(ids)`` sets host-side tombstones; the segments' rows are
  untouched and deleted rows are left out exactly at query time;
- ``knn_dot`` / ``knn`` / ``knn_cosine`` run one K1 scan per segment
  (``csrc/knn.cu`` on the card, its plain version on the CPU), which
  returns raw keys and permanent ids, merge the segments' candidates on
  the device on those keys, best key first and then the lowest permanent
  id (:func:`~innr_tpu_torch.utils.order.merge_parts`), decode the winners
  once (:func:`~innr_tpu_torch.kernels.knn.decode_keys`), and copy them to
  the host once per query batch (:func:`~innr_tpu_torch.utils.tensors.
  to_host`);
- ``compact()`` folds the alive rows of every segment into one, on the
  device, and runs automatically (size-tiered) when the tombstone fraction
  exceeds ``max_dead_frac`` or the segment count exceeds ``max_segments``.

Ids are permanent: ``add`` returns the range, results report ids, and
``compact`` keeps them.

Tombstones. The JAX package over-fetches ``k + tombstones`` per segment,
rounded up to a power of two so that XLA compiles few shapes. On the H100
each 256 of k costs K1 a pass, so a segment a quarter dead at 10M rows
would take thousands. Here a segment with tombstones is scanned in K1's
masked mode ("dotm" / "l2m" / "cosinem") with its alive mask: a dead row
keys INT32_MIN and can never beat an alive one, so ``min(k, alive rows)``
candidates per segment are exact. Alive rows' scores are the unmasked
scan's, bit for bit. No alive row keys INT32_MIN (K1 keys a NaN score as
the quiet NaN 0x7FC00000), so no dead row can come back and there is no
guard after the scan.

One key space. Every segment keys the same query with the same formula,
so the segments' raw keys compare as they stand, and the merged result is
one full scan of the alive rows (with their permanent ids as K1's row-id
map) bit for bit, ties included. That holds where L2 distances clamp: K1's
L2 key lacks ``||q||^2``, so rows whose keys differ may decode to the same
0.0, and they keep K1's key order, as in ``batch_knn``, the sharded family
and ``IVFIndex``. The JAX package re-keys each segment from its decoded
scores and so orders those rows by id.

While a profiler records (:mod:`innr_tpu_torch.utils.trace`), a search is an
``index.call`` span: ``index.to_device`` (the queries' copy to the device),
one ``index.segment`` child per segment scanned (its K1 pass alone), then
``index.merge`` (the merge and the decode; attributes ``segments``, the
segments scanned, and ``candidates``, the merged keys per query) and
``index.to_host``, the one host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from innr_tpu_torch import config
from innr_tpu_torch.batch import VerticalBatch
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.utils import trace as _trace
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import merge_parts
from innr_tpu_torch.utils.tensors import as_tensor, to_host

__all__ = ["SegmentedCorpus"]

_MASKED = {"dot": "dotm", "l2": "l2m", "cosine": "cosinem"}


class _Segment:
    """An immutable block of rows with its permanent ids and tombstones."""

    def __init__(self, rows: torch.Tensor, ids: np.ndarray):
        self.vb = VerticalBatch(rows)
        self.ids = ids  # (n,) int64 permanent ids, ascending
        self.alive = np.ones(len(ids), bool)
        self.n_alive = len(ids)  # alive.sum(), kept by delete
        self._ids_dev = None
        self._alive_dev = None
        self._aux = {}

    @property
    def n_dead(self) -> int:
        return len(self.ids) - self.n_alive

    def ids_dev(self) -> torch.Tensor:
        """Permanent ids on the device as int32 (``add`` guards the 2^31
        ceiling), cached."""
        if self._ids_dev is None:
            self._ids_dev = torch.from_numpy(self.ids.astype(np.int32)).to(self.vb.rows.device)
        return self._ids_dev

    def alive_dev(self) -> torch.Tensor:
        """The tombstone mask on the device, dropped on delete."""
        if self._alive_dev is None:
            self._alive_dev = torch.from_numpy(self.alive.copy()).to(self.vb.rows.device)
        return self._alive_dev

    def kill(self, tgt: np.ndarray) -> int:
        """Tombstone the rows at positions ``tgt``; returns how many were
        alive."""
        newly = int(self.alive[tgt].sum())
        if newly:
            self.alive[tgt] = False
            self.n_alive -= newly
            self._alive_dev = None
            self._aux = {}
        return newly

    def scan_args(self, mode: str):
        """``(aux, scan mode)`` of K1 for this segment: the unmasked mode
        while nothing is deleted, else the masked mode with the alive mask
        (cached until the next delete)."""
        if self.n_dead == 0:
            aux = {"dot": None, "l2": self.vb.norms2(), "cosine": self.vb.inv_norms()}[mode]
            return aux, mode
        if mode not in self._aux:
            alive = self.alive_dev().to(torch.float32)
            if mode == "dot":
                self._aux[mode] = alive
            else:
                vals = self.vb.norms2() if mode == "l2" else self.vb.inv_norms()
                self._aux[mode] = torch.stack([vals, alive])
        return self._aux[mode], _MASKED[mode]


class SegmentedCorpus:
    """A mutable f32 corpus: immutable scan segments and tombstones.

    Rows live on ``device`` (default :func:`innr_tpu_torch.config.
    default_device`, the card); host data and tensors given to :meth:`add`
    are copied there. ``auto_compact``: run :meth:`compact` when the
    tombstone fraction exceeds ``max_dead_frac`` or the segment count
    exceeds ``max_segments`` (manual :meth:`compact` always works)."""

    def __init__(self, dimension: int, *, auto_compact: bool = True,
                 max_dead_frac: float = 0.25, max_segments: int = 16, device=None):
        if int(dimension) <= 0:
            raise ContractError("SegmentedCorpus: dimension must be positive")
        self._dim = int(dimension)
        self._device = torch.device(device) if device is not None else config.default_device()
        self._segments: list[_Segment] = []
        self._next_id = 0
        self.auto_compact = bool(auto_compact)
        self.max_dead_frac = float(max_dead_frac)
        self.max_segments = int(max_segments)

    # ------------------------------------------------------------- mutate --
    def add(self, rows) -> tuple[int, int]:
        """Append rows as a new immutable segment. Returns the permanent
        ``(first_id, last_id + 1)`` range assigned to them."""
        given = rows
        rows = as_tensor(rows, torch.float32, self._device)
        if rows.dim() != 2 or rows.shape[1] != self._dim:
            raise ContractError(
                f"SegmentedCorpus.add: rows must be (N, {self._dim}), got {tuple(rows.shape)}")
        n = int(rows.shape[0])
        if n == 0:
            return self._next_id, self._next_id
        if self._next_id + n >= 2**31:
            raise ContractError("SegmentedCorpus.add: permanent id space exhausted (2^31)")
        if isinstance(given, torch.Tensor) and rows.data_ptr() == given.data_ptr():
            rows = rows.clone()  # a segment is immutable: never the caller's storage
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._segments.append(_Segment(rows.contiguous(), ids))
        self._next_id += n
        self._maybe_compact()
        return int(ids[0]), int(ids[-1]) + 1

    def delete(self, ids) -> int:
        """Tombstone rows by permanent id. Unknown and already-deleted ids
        are ignored. Returns the number of rows newly deleted. Each segment's
        ids ascend, so the lookup is one ``searchsorted`` per segment, of
        the ids within its range only."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.unique(np.atleast_1d(np.asarray(ids, dtype=np.int64)))
        deleted = 0
        for seg in self._segments:
            if len(seg.ids) == 0:
                continue
            mine = ids[np.searchsorted(ids, seg.ids[0]):
                       np.searchsorted(ids, seg.ids[-1], side="right")]
            pos = np.clip(np.searchsorted(seg.ids, mine), 0, len(seg.ids) - 1)
            deleted += seg.kill(pos[seg.ids[pos] == mine])
        if deleted:
            self._maybe_compact()
        return deleted

    def _maybe_compact(self) -> None:
        """Size-tiered auto-compaction."""
        if not self.auto_compact or not self._segments:
            return
        total = sum(len(s.ids) for s in self._segments)
        if (len(self._segments) > self.max_segments
                or (total > 0 and self.num_deleted / total > self.max_dead_frac)):
            self.compact()

    def compact(self) -> None:
        """Fold every segment's alive rows into one segment, on the device
        (ids kept): one allocation, each alive row copied once into its
        place. Scans over many segments pay one launch each."""
        if not self._segments:
            return
        n = self.num_vectors
        if n == 0:
            self._segments = []
            return
        rows = torch.empty((n, self._dim), dtype=torch.float32, device=self._device)
        ids = np.empty(n, dtype=np.int64)
        at = 0
        for s in self._segments:
            m = s.n_alive
            if m == len(s.ids):
                rows[at:at + m].copy_(s.vb.rows)
                ids[at:at + m] = s.ids
            elif m:
                keep = np.flatnonzero(s.alive)
                torch.index_select(s.vb.rows, 0, torch.from_numpy(keep).to(self._device),
                                   out=rows[at:at + m])
                ids[at:at + m] = s.ids[keep]
            at += m
        self._segments = [_Segment(rows, ids)]

    # ------------------------------------------------------------ inspect --
    @property
    def dimension(self) -> int:
        return self._dim

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_vectors(self) -> int:
        """Alive rows."""
        return sum(s.n_alive for s in self._segments)

    @property
    def num_deleted(self) -> int:
        return sum(s.n_dead for s in self._segments)

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    def memory_bytes(self) -> int:
        """Bytes of the segments' rows on the device."""
        return sum(s.vb.rows.numel() * s.vb.rows.element_size() for s in self._segments)

    # ------------------------------------------------------------- search --
    def _run(self, queries, k: int, mode: str, op: str):
        """One K1 scan per segment with its permanent ids as the row-id map
        (raw keys and ids, min(k, alive rows) of them), one composite top-k
        merge of the raw keys (best key first, then the lowest permanent
        id), one decode of the (Q, k) winners, one host copy. Nothing guards
        the result against dead rows: a masked scan cannot return one (the
        module's notes), and the tests hold it so."""
        with _trace.span("index.call"):
            with _trace.span("index.to_device"):
                qs = as_tensor(queries, torch.float32, self._device)
            single = qs.dim() == 1
            if single:
                qs = qs[None, :]
            if qs.dim() != 2 or qs.shape[1] != self._dim:
                raise ContractError(
                    f"innr_tpu_torch::{op}: queries must be (Q, {self._dim}), got "
                    f"{tuple(qs.shape)}")
            qs = qs.contiguous()
            n_q = int(qs.shape[0])
            k = min(int(k), self.num_vectors)
            if k <= 0:
                scores, ids = np.zeros((n_q, 0), np.float32), np.zeros((n_q, 0), np.int64)
                return (scores[0], ids[0]) if single else (scores, ids)
            if mode == "cosine":
                qs = _knn._unit_queries(qs)
            parts, candidates = [], 0
            for seg in self._segments:
                if seg.n_alive == 0:  # covers an empty segment too
                    continue
                with _trace.span("index.segment"):
                    aux, scan_mode = seg.scan_args(mode)
                    k_seg = min(k, seg.n_alive)
                    parts.append(_knn.fused_knn_keys_batch(qs, seg.vb.rows, aux, k_seg,
                                                           scan_mode, row_ids=seg.ids_dev()))
                candidates += k_seg
            with _trace.span("index.merge", segments=len(parts), candidates=candidates):
                keys, ids = merge_parts(parts, k, qs.device)
                scores = _knn.decode_keys(keys, mode, qs)
            with _trace.span("index.to_host"):
                scores, ids = to_host(scores, ids)
            return (scores[0], ids[0]) if single else (scores, ids)

    def knn_dot(self, queries, k: int):
        """Top-k MIPS over the alive rows: ``(scores descending, permanent
        ids)`` as numpy arrays. Takes (D,) or (Q, D)."""
        return self._run(queries, k, "dot", "segmented_knn_dot")

    def knn(self, queries, k: int):
        """Top-k exact L2^2 (ascending) over the alive rows."""
        return self._run(queries, k, "l2", "segmented_knn")

    def knn_cosine(self, queries, k: int):
        """Top-k cosine (descending) over the alive rows."""
        return self._run(queries, k, "cosine", "segmented_knn_cosine")
