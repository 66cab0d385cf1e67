"""Two-stage retrieval: a quantized coarse scan, then an exact rerank.

The counterpart of :mod:`innr_tpu.pipeline`, the library's serving entry
point. A :class:`TwoStageIndex` owns the f32 corpus plus one coarse
representation of it, and answers a query batch with

1. **coarse**: a scan of the compressed corpus for ``k * rerank_factor``
   candidates per query — ``"binary"`` (1 bit a dimension) and
   ``"ternary"`` (2 bits) on the packed kNN kernel (``csrc/packed_knn.cu``),
   ``"u8"`` (8 bits, asymmetric) and ``"matryoshka"`` (an f32 prefix of the
   dimensions) on the dense kNN kernel (``csrc/knn.cu``);
2. **fine**: exact f32 dot products of each query with its shortlist (a
   gather and one batched product) and a total-order top-k.

The whole search is queued on the current CUDA stream; the host waits once,
for the copy of the result pair. The shortlist of k * rerank_factor may be
larger than one kernel pass selects (:func:`.kernels.knn.single_pass_k`):
it then runs as several exclusion-bounded passes, where the JAX package
hands it to ``jax.lax.top_k``; both select the same rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from innr_tpu_torch.batch import BatchKnnResult, VerticalBatch, batch_knn_dot
from innr_tpu_torch.kernels import knn as _knn
from innr_tpu_torch.kernels import packed_knn as _packed
from innr_tpu_torch.ops import binary as _binary
from innr_tpu_torch.ops import scalar as _scalar
from innr_tpu_torch.ops import ternary as _ternary
from innr_tpu_torch.utils.asserts import ContractError
from innr_tpu_torch.utils.order import top_k_total
from innr_tpu_torch.utils.tensors import as_tensor, to_host

__all__ = ["TwoStageIndex", "CoarseConfig"]


@dataclass(frozen=True)
class CoarseConfig:
    """Coarse-stage configuration.

    ``kind``: "binary" | "ternary" | "u8" | "matryoshka".
    ``threshold``: encode threshold for binary/ternary.
    ``prefix_dims``: prefix length for matryoshka.
    ``quantile``: u8 fit quantile (1.0 = plain min/max fit).
    """

    kind: str = "binary"
    threshold: float = 0.0
    prefix_dims: int = 128
    quantile: float = 1.0


def rerank(rows, queries, cand, k: int):
    """Exact rerank of per-query shortlists: ``rows[cand]`` (Q, C, D) times
    the (Q, D) queries in float32, then the total-order top k. Returns
    ``(scores (Q, k), indices (Q, k) int64)``."""
    cand = cand.long()
    fine = torch.bmm(rows[cand], queries[:, :, None])[:, :, 0]
    vals, pos = top_k_total(fine, k, largest=True)
    return vals, torch.gather(cand, 1, pos)


def fit_params(config: CoarseConfig, rows) -> _scalar.QuantizationParams:
    """The u8 coarse stage's parameters over the whole corpus: min / max,
    or the ``config.quantile`` clip."""
    if config.quantile >= 1.0:
        return _scalar.QuantizationParams.fit(rows)
    return _scalar.QuantizationParams.fit_quantile(rows, config.quantile)


def build_coarse(config: CoarseConfig, rows: torch.Tensor, params, op: str):
    """The coarse representation of (N, D) f32 ``rows`` on their device, as
    :func:`coarse_candidates` scans it; ``params`` for the u8 kind."""
    kind = config.kind
    if kind == "binary":
        return _binary.PackedBinaryBatch.encode(rows, config.threshold)
    if kind == "ternary":
        return _ternary.PackedTernaryBatch.encode(rows, config.threshold)
    if kind == "u8":
        return _scalar.QuantizedU8Batch.quantize(rows, params)
    if kind == "matryoshka":
        # The dense kernel streams contiguous rows; the JAX package
        # materialises the slice too.
        return rows[:, :min(config.prefix_dims, int(rows.shape[1]))].contiguous()
    raise ContractError(f"{op}: unknown coarse kind {kind!r}")


def coarse_candidates(config: CoarseConfig, coarse, queries: torch.Tensor, n_cand: int):
    """The coarse scan of ``config.kind`` over its representation ``coarse``
    (a :class:`~innr_tpu_torch.ops.binary.PackedBinaryBatch`, a
    :class:`~innr_tpu_torch.ops.ternary.PackedTernaryBatch`, a
    :class:`~innr_tpu_torch.ops.scalar.QuantizedU8Batch` or the contiguous
    matryoshka prefix rows): ``(keys, indices)`` (Q, n_cand), best first.
    Keys are ``-count`` (binary), the ternary dot, the raw u8 mixed dot's
    total-order key, or the prefix dot's."""
    kind = config.kind
    if kind == "matryoshka":
        qp = queries[:, : coarse.shape[1]].contiguous()
        return _knn.fused_knn_keys_batch(qp, coarse, None, n_cand, "dot")
    if kind == "u8":
        # Selection needs only the raw mixed dot: the affine correction is
        # per-query monotone (alpha > 0) and cannot reorder rows.
        return _knn.fused_knn_keys_batch(queries, coarse.codes, None, n_cand, "dot")
    t = config.threshold
    if kind == "binary":
        q_words = _binary.encode_binary_batch(queries, t)
        return _packed.fused_packed_keys_batch((q_words,), (coarse.words_t,), n_cand)
    qp, qn = _ternary.encode_ternary_batch(queries, t)
    return _packed.fused_packed_keys_batch((qp, qn), (coarse.pos_t, coarse.neg_t), n_cand)


class TwoStageIndex:
    """Coarse-quantized scan + exact f32 rerank over an (N, D) corpus.

    ``rows``: an (N, D) tensor (it stays on its device unless ``device`` is
    given) or host data (placed on ``device``, default
    :func:`innr_tpu_torch.config.default_device`, the card)."""

    def __init__(self, rows, coarse: CoarseConfig | str = "binary", rerank_factor: int = 4,
                 device=None):
        if isinstance(coarse, str):
            coarse = CoarseConfig(kind=coarse)
        self.config = coarse
        self.rerank_factor = int(rerank_factor)
        if self.rerank_factor < 1:
            raise ContractError("TwoStageIndex: rerank_factor must be >= 1")
        rows = as_tensor(rows, torch.float32, device).contiguous()
        if rows.dim() != 2:
            raise ContractError("TwoStageIndex: rows must be 2-D (N, D)")
        self.rows = rows

        if coarse.kind == "u8":
            self.params = fit_params(coarse, rows)
        self._coarse = build_coarse(coarse, rows, getattr(self, "params", None),
                                    "TwoStageIndex")

    @property
    def num_vectors(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.rows.shape[1])

    def memory_bytes(self) -> dict:
        """Bytes of the f32 rows and of the coarse representation."""
        fine = int(self.rows.numel()) * 4
        kind = self.config.kind
        if kind == "matryoshka":
            coarse = int(self._coarse.numel()) * 4
        else:
            coarse = self._coarse.memory_bytes()
        return {"fine_f32": fine, f"coarse_{kind}": coarse}

    # -- search ---------------------------------------------------------------

    def candidates(self, queries: torch.Tensor, n_cand: int):
        """The coarse stage: ``(keys, indices)`` (Q, n_cand) on the corpus
        device, best first (:func:`coarse_candidates`)."""
        return coarse_candidates(self.config, self._coarse, queries, n_cand)

    def _search(self, queries: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Coarse scan and rerank on the device, then one wait for the host
        copy of ``(scores, indices)``."""
        k = min(int(k), self.num_vectors)
        n_cand = min(k * self.rerank_factor, self.num_vectors)
        _, cand = self.candidates(queries, n_cand)
        return to_host(*rerank(self.rows, queries, cand, k))

    def _queries(self, queries, rank: int, op: str) -> torch.Tensor:
        q = as_tensor(queries, torch.float32, self.rows.device).contiguous()
        if q.dim() != rank or q.shape[-1] != self.dimension:
            want = "(D,)" if rank == 1 else "(Q, D)"
            raise ContractError(
                f"TwoStageIndex.{op}: queries shape {tuple(q.shape)} != {want} "
                f"with D = {self.dimension}"
            )
        return q

    def search(self, query, k: int) -> BatchKnnResult:
        """Top-k by exact dot product, shortlisted by the coarse stage;
        scores descending."""
        q = self._queries(query, 1, "search")
        if self.num_vectors == 0 or k == 0:
            return BatchKnnResult(indices=np.zeros((0,), np.int64),
                                  scores=np.zeros((0,), np.float32))
        vals, idx = self._search(q[None, :], k)
        return BatchKnnResult(indices=idx[0], scores=vals[0])

    def search_batch(self, queries, k: int) -> BatchKnnResult:
        """Batched search: (Q, D) queries -> (Q, k) results, one coarse scan
        for the batch (one corpus read per kernel pass) and one batched
        rerank."""
        qs = self._queries(queries, 2, "search_batch")
        n_q = int(qs.shape[0])
        if self.num_vectors == 0 or k == 0 or n_q == 0:
            return BatchKnnResult(indices=np.zeros((n_q, 0), np.int64),
                                  scores=np.zeros((n_q, 0), np.float32))
        vals, idx = self._search(qs, k)
        return BatchKnnResult(indices=idx, scores=vals)

    def recall_vs_exact(self, queries, k: int) -> float:
        """Mean recall@k of :meth:`search_batch` against exact search
        (``batch_knn_dot`` on the f32 rows)."""
        qs = self._queries(queries, 2, "recall_vs_exact")
        if qs.shape[0] == 0:
            return 0.0
        exact = batch_knn_dot(qs, VerticalBatch(self.rows), k).indices
        got = self.search_batch(qs, k).indices
        hits = [len(set(e.tolist()) & set(g.tolist())) / max(len(e), 1)
                for e, g in zip(exact, got)]
        return float(np.mean(hits))
